#!/usr/bin/env python3
"""Drive the PyTorch port (``stoke_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is
   switched off for matmuls and cuDNN so float32 means float32.
2. build: compile the port's CUDA kernels from ``stoke_tpu_torch/csrc``,
   one ``nvcc`` per source, all at once; print ptxas's register and spill
   lines.
3. kernels: each kernel against its plain PyTorch version at its path's
   shapes, with its time, the plain version's, the least time the card
   could take (``bound_ms``) and a PyTorch library call's where one
   computes the same function: the flash forward (also replayed from a
   CUDA graph, ``graph_ms``) at the serve shapes; the paged decode
   kernels (split context walk) at the serve shapes (B=8, H=12, D=64,
   fp32 and bf16 pools, an inactive slot), at D=128, with bf16 queries
   over a bf16 pool, with a slot at context 512 and with one at context
   0 (held to exact zeros), each also with ``graph_ms``; the
   flash forward in bf16 (``wgmma``) and in fp32 (3xTF32
   ``mma.sync``) at the training shape (B=8, H=12, L=1024, D=64, causal),
   at D=128, at a ragged L=1000, without the causal rule, and at D=128
   with fully masked rows, and the same cases in fp16 (the ``wgmma``
   kernels' fp16 instantiations); the flash backward's dQ and dK/dV kernels at
   the training shapes (B=8, H=12, D=64, causal, L 512 and 1024, fp32 and
   bf16), masked cases with fully masked rows in fp32 and bf16, fp32 and
   bf16 at D=128, at L=1000 and without the causal rule, and bf16 masked
   at D=128 (bf16 dQ, dK and dV also held row by row: ``bwd_row_err``),
   fp16 at the bf16 cases' paths and with dO scaled by the starting loss
   scale 2^16 and at the training step's small dS (``BWD_FP16_CASES``,
   held row by row too, with the largest |dS| and the power of two the
   kernels scale dS by),
   timed beside SDPA's backward alone, with ptxas's registers and spills
   of the fp32 (3xTF32 ``mma.sync``) forward and backward kernels and of
   the decode and verify kernels; a bf16 dQ call at an unsupported head
   dim must raise; and the paged verify kernels (split context walk) at
   the speculative serve shapes
   (B=8, H=12, S=5, D=64, fp32 and bf16 pools, an idle slot and clamped
   padding rows), at D=128, at S=16, with bf16 queries over a bf16 pool
   and with a slot at position 511, each also timed as launches replayed
   from a CUDA graph (``graph_ms``); and the int8 quantize and
   dequantize kernels (``csrc/quant.cu``) bit for bit against their plain
   versions at a 25 MB bucket and at GPT-base's whole gradient (the plain
   version a bucket at a time), stochastic at chunk 512 and nearest at
   chunk 128, with a ragged last chunk, each with ``ms``, ``graph_ms``,
   ``plain_ms`` and the bytes' bound.
4. serve: GPT-base at full width (seeded random weights, fp32) behind
   ``ServingEngine`` with the flash prefill and paged-decode kernels;
   16 requests submitted in three waves; launch counts checked against
   the layers and steps; greedy streams held against the same engine on
   the plain attention path; then one more drive under ``torch.profiler``
   for the card's busy share and the decode kernels' device ms per
   launch (``decode_ms_per_launch``).
5. serve_spec: the same GPT-base behind the speculative engine
   (``sampling=True, speculative_k=4, prefill_chunk_tokens=128``; the
   verify kernel, packed chunked prefill, threefry sampling) on 16
   re-quoting prompts in the three waves, greedy and sampled (temperature
   0.8, top-k 50, top-p 0.95), each against the same config without
   speculation: verify launches are 12 per verify dispatch, decode
   launches 0, greedy streams and the pre-sampling logits match the
   non-speculative engine's; prints tokens/s, TTFT/TPOT, tokens per
   dispatch, acceptance, the sampler's card time and the verify kernels'
   profiled device ms per launch.
6. train: the training path at full width: GPT-base (vocab 50257,
   max_len 1024) through ``Stoke`` in bf16 with flash attention, AdamW and
   norm clipping, B=8, L=1024, on the example corpus through
   ``Stoke.DataLoader``: 2 warm-up and 10 timed ``train_step``s, each of
   the forward and both backward kernels launched 12 times a step; the
   loss must fall; the profiled step must show the tensor-core dQ kernel
   12 times and the scalar one never. Then one four-call step at
   ``grad_accum=2``, with its counters checked. Prints step ms p50,
   tokens/s, peak memory and the losses. Then GPT-base with
   ``chunked_head=True`` and ``chunked_causal_lm_loss`` (bf16 operands
   under the bf16 policy, fp32 logits): on one batch's hidden states and
   embedding its loss and gradients against the fp32 full-logits cross
   entropy (loss 1e-5 relative, gradients 2^-7 in L2 norm); over the same
   batches from the same weights its first loss within 2^-8 of the full
   head's, 12 launches of each flash kernel a step, the loss falls,
   ``train_steps`` replays its eager losses bit for bit; step ms p50
   eager and replayed, peak memory and each head's share of the profiled
   step's kernel time (the head alone, forward and backward, timed by
   CUDA events).
7. train_parity: the same seeded GPT-base in fp32 at B=2, L=512 for 3
   ``train_step``s through the kernels (the fp32 forward's and backward's
   3xTF32 tensor-core kernels, 36 launches each) and through dense
   attention (no kernel); the losses must agree within 1e-3 relative.
8. train_window: GPT-base in bf16 (the train phase's setup) through
   ``train_steps``, each window a replayed CUDA graph: 12 eager
   ``train_step``s against ``train_steps`` over the same 12 batches, and
   with ``segment_size=4`` (losses within 1e-6 relative, counters, 144
   launches of each flash kernel through the replays);
   ``train_step_window`` at ``grad_accum=2`` against the four-call loop;
   step ms p50 and a profiled busy share of replayed windows beside the
   eager steps'; dropout 0.1 at 2 blocks: whether replays draw the eager
   masks, fresh masks each replay, a falling loss.
9. train_fp16: GPT-base in fp16 with the dynamic loss scaler through the
   fp16 kernels: 12 eager ``train_step``s against ``train_steps`` (losses
   within 1e-6), the loss falls, the profiled step runs each fp16 kernel
   12 times and no bf16 or fp32 one; the largest |dS| of a step; then a
   window whose loss is multiplied by inf, eagerly and replayed: the
   parameters and AdamW state stay bit for bit, the scale halves, one
   step is skipped.
10. checkpoint: GPT-base in bf16 (the train phase's setup) at
   ``grad_accum=2`` through ``Stoke.save`` / ``load`` in a temporary
   directory: 4 replayed steps with async auto-saves at steps 2 and 4
   (``max_to_keep=2``), an explicit save mid-window and 5 more
   micro-batches; a run of other weights and seed loads the mid-window
   tag and repeats them (losses and masters bit for bit); the saver loads
   the step-4 tag under its captured window and replays one window, bit
   for bit against a fresh run that resumes the newest tag
   (``maybe_resume``) and loads the same one; the same resume in fp16 at
   2 blocks (the loss scale and growth count as saved); 2 auto tags kept
   and ``meta.json``'s JAX keys; ``serve()``'s greedy tokens against an
   engine built from the same weights (flash prefill and paged decode
   launched); ``estimate_step_flops`` through the flash kernels equal to
   the dense model's. Prints save and load ms, the tags' bytes, the step
   that an async save overlaps beside the same step without one, and the
   phase's seconds.
11. train_resnet50: ResNet-50 v1.5 at its published widths, CIFAR stem, 10
   classes, channels_last, bf16 over fp32 masters, SGD(0.05, momentum
   0.9), batch 256 of seeded 32x32 images (``bench.py``'s configuration):
   12 eager ``train_step``s against ``train_steps`` over the same batches
   (losses and BatchNorm running statistics bit for bit, the statistics
   moved, the loss falls), two eval-mode forwards alike, no flash launch;
   step ms p50 eager and replayed, images/s, peak memory, a profiled step
   of each (busy share, the five costliest kernels), the step's FLOPs by
   ``torch.utils.flop_counter`` and their share of the bf16 peak
   (``mfu``), and the memory format of the input, weights and output.
12. train_vit: ViT-Base/16 at 224x224 in bf16 with AdamW, batch 64, 8
   eager ``train_step``s: the loss falls; step ms and peak memory.
13. train_bert: BERT-base sequence classification (12 x 768, vocab
   30522, max_len 512, 2 classes) built by ``stoke_from_config`` from a
   dict (bf16, ``grad_accum=2``, clip norm 1.0, optax-named AdamW(1e-4),
   a ``TensorboardConfig`` every 5 steps) over 8192 synthetic sequences of
   long-tailed lengths 8-512 in a ``RaggedSequenceDataset(pad_multiple=32)``
   under ``BucketedDistributedSampler(buckets=8, batch_size=32)``, each
   batch gathered and padded by the C++ batcher: first the three flash
   kernels at its attention shape (B=32, H=12, D=64, non-causal, the key
   mask of a bucketed batch, bf16) at L 32, 96 and 512 against their plain
   versions and SDPA with the same mask; then 40 four-call micro-steps
   (20 optimizer steps): the loss falls below half of chance, every L a
   multiple of 32 up to 512, 12 launches of each flash kernel a
   micro-step, every batch assembled natively, the event file holds the
   logged losses; step ms p50 by L, real and padded tokens/s, the
   padding share of an epoch bucketed against shuffled, ``gather_pad`` ms native against numpy, peak
   memory, a profiled step at L=512 with the flash kernels' share; then
   fp32 through the kernels against dense attention for 3 optimizer steps
   (losses within 1e-3).
14. train_dp: the DP / ZeRO ladder (``distributed="dp"`` with plain dp,
   oss, oss + sddp and fsdp) in a one-process NCCL group, world 1 (the
   card shows that each tier runs over NCCL, that its collectives launch
   and are captured in the replayed windows, and that the flash kernels
   run under it; nothing crosses cards): GPT-base in fp32 at B=2, L=512,
   3 four-call steps per tier against the run without ``distributed``
   (losses within 1e-3, the largest parameter difference printed);
   GPT-base bf16 at B=8, L=1024 per tier and once without
   ``distributed``: 4 eager four-call steps, ``train_steps`` over 8
   batches in segments of 4, 6 replayed windows timed one a call, the
   flash kernels' launches, a window captured, a profiled eager step
   that must launch NCCL kernels (their names, launches and device ms,
   and the host's ``nccl:*`` calls) and a profiled replayed window, peak
   memory; ResNet-50 bf16 from a ``stoke_from_config`` dict with
   ``examples/cifar10/config/dp_oss_sddp.yaml``'s flags (batch 64,
   32x32), 4 ``train_step``s against the same dict without
   ``distributed``: every BatchNorm's all-reduce on (two a layer in a
   profiled step), the running statistics within four units of bf16's
   rounding. The process group is destroyed at the end.
15. train_comm: the gradient transports (``CommConfig``) in a one-process
   NCCL group, GPT-base bf16 at B=8, L=1024: int8 under dp and oss (the
   replicated schedule) and under oss+sddp and fsdp (the sharded one),
   bf16 and the fp32 pass-through under dp, and dp without a
   ``CommConfig``; each run 4 eager steps, 4 ``train_steps`` windows in
   segments of 2 and 6 replayed windows timed one a call, against a
   second run's eager steps on the same batches (equal bit for bit); the
   fp32 transport equal to no transport bit for bit; the quantize pair
   launched every int8 step, its device ms and share in a profiled
   replayed window. At world 1 the transports take their local round
   trip: this shows the kernels and their capture, not the wire.
16. checkpoint_dp: GPT-base bf16 cut to 2 blocks at ``grad_accum=2`` in a
   one-process NCCL group, every tier x {consolidated, sharded} x {sync,
   async}: a save mid-window, a fresh run loads it and continues eagerly
   and in replayed windows, bit for bit against the run that saved;
   save ms, the async write's wait, load ms and the tag's bytes.
17. serve_quant (run after phase 5): the serve trace with
   ``ServeConfig(quant="int8")`` and ``quant="bf16"`` beside the plain
   engine: compression over the quantized leaves, the greedy choice
   scored on the plain streams' context (>= 99%), each divergence of a
   free-running int8 stream a near-tie, the dequantize kernel once a
   quantized leaf every dispatch; tokens/s, TPOT, parameter bytes, each
   engine's bytes on the device after its build
   (``engine_bytes_on_device``) and its own peak (``engine_peak_gib``:
   the build plus what its drive added above the memory in use when the
   drive began; the other engines stay allocated across the loop).
18. train_telemetry (run after phase 8): GPT-base bf16 (the train
   phase's setup) once without configs and once with
   ``TelemetryConfig(log_every_n_steps=1)``, ``TraceConfig``,
   ``HealthConfig(sentinels=True, watchdog=True)`` and
   ``ProfilerConfig``, over the same batches: 12 timed eager
   ``train_step``s and a profiled one, ``train_steps`` over 4 windows,
   12 timed one-window replays and a profiled one, two four-call steps;
   the flash launches, ``dispatch_count``, losses and final parameters
   equal (bit for bit); step ms p50 eager and replayed side by side with
   busy shares and profiled kernel launches; ``steps.jsonl`` validated
   line by line, ``metrics.prom``, the exported trace's
   ``stoke/dispatch`` / ``stoke/step`` spans once a step, a sentinel row
   a step; each four-call step's sentinel grad norm, parameter norm and
   update ratio against the host's fp64 recompute (rel 1e-5), its
   non-finite fields exact; the non-finite flags on CUDA leaves with a
   NaN, +-inf, huge finite values, bf16 and fp16 against
   ``any(~isfinite)``; then a fresh GPT-base whose one named
   parameter's gradient a hook makes NaN at step 3 (the detector fires
   at step 3 naming its JAX leaf path; the bundle's files);
   ``profile_trace`` naming the three flash kernels; and the serve
   trace drive untraced and traced (span counts by name and request,
   TPOT p50 of each, the prefill and decode kernels' launches).
19. train_resilience: GPT-base bf16 with dropout 0.1 (the generator's
   state is part of what a resume restores): the reference schedule (3
   eager steps, ``train_steps`` of 3 to step 12) without configs and
   with a ``ResilienceConfig`` and a periodic async save staged through
   pinned memory (dispatches, flash launches, losses and masters equal;
   eager and replayed step ms p50); a staged snapshot held bit for bit
   across the step after it; the async save's stall, write and peak
   device bytes, plain and staged (the first staged save with an empty
   pinned pool); three lives of one run (preempted at an eager step, then
   by a SIGTERM that lands during replayed windows, then to the end:
   bit for bit against the reference); a supervised run (``python -m
   stoke_tpu_torch.supervise`` over ``chip_smoke.py
   --resilience-worker``, SIGKILLed after step 3, resumed from the
   periodic tag: bit for bit, each life's seconds); ``corrupt_save=2``
   and ``kill_during_save=1`` (2 blocks: the newest or partial tag
   quarantined); a tag that a CPU gloo world of 2 wrote (GPT-base width,
   2 blocks, the int8 sharded transport) resumed at world 1 on the card,
   its residual exactly the host remap, the quantize pair launched.
20. offload: GPT-base bf16, 5 eager steps and 2 windows (one replayed)
   with no offload, ``OffloadOptimizerConfig``, ``OffloadDiskConfig``,
   and fsdp in a one-process NCCL group without and with
   ``OffloadParamsConfig``: bit for bit against the same tier without
   offload, the state pinned or spilled between steps, the peak device
   bytes after the first step and the step ms.
21. train_remat: GPT-base bf16 with dropout 0.1 without and with
   ``remat=True`` (each block recomputed in backward, its dropout masks
   replayed): 6 eager steps and ``train_steps`` of 3 windows to step 12,
   losses and masters bit for bit, then timed replays; eager and
   replayed step ms p50 and the peak device bytes of each; the flash
   forward launched exactly twice as often as each backward kernel; one
   eager step and two windows under each ``ActivationCheckpointingConfig``
   policy (captured under the selective policies too), bit for bit; the
   untied head (``tie_embeddings=False``) trains.
22. observatories: GPT-base bf16 with ``TelemetryConfig``,
   ``AttributionConfig(peak_tflops=989, peak_hbm_gbps=3350)``,
   ``MemoryConfig`` and ``NumericsConfig`` against the same run without:
   losses, parameters and dispatches bit for bit; the ledger against the
   allocator's bytes between steps, the pre-flight's prediction; the
   fused card's FLOPs against ``estimate_step_flops``; every logged
   ``mfu`` and ``hbm_bw_util`` in (0, 1]; a replayed window's numerics
   rows against the host's recompute; then the serve trace (decode
   kernel) and the speculative trace (verify kernel) plain and with cost
   cards, SLO targets and a ``MemoryConfig``: streams equal, MFU and
   bandwidth utilization in (0, 1], the SLO counts, TPOT p50 of each.

23. fleet_ops: GPT-base bf16 with ``TelemetryConfig``, ``TraceConfig``,
   ``HealthConfig`` and ``AttributionConfig``, without and with
   ``FleetConfig(window_steps=2)`` and ``OpsPlaneConfig(port=0)``, over
   the same batches (8 eager steps, ``train_steps`` of 4 windows, 6
   replays): losses, masters, dispatches and flash launches bit for bit;
   the ``fleet/*`` step-event fields on the window boundaries, ``hosts``
   1; a thread scraping /metrics, /healthz, /statusz, /requests and
   /trace throughout, each answer 200 in its shape; /profile scraped
   during training (200, 409 while it runs, 429 past the budget of one,
   405 for a POST), its trace naming the three flash kernels; then
   ``Stoke.serve()`` of each run on the serve trace, the plane's engine
   scraped on /requests while it drives: the decode kernel launched,
   the streams equal, TPOT p50 of both.
24. train_seqpar: GPT-base bf16 at world 1 under a (data=1, seq=1) mesh
   with ``shard_seq_dim=1`` through ring, zigzag and Ulysses attention,
   each bit for bit against flash attention (losses, masters, launches,
   eager and replayed); then S=4 virtual shards of L=4096 in one process
   (B=2, H=12, D=64), the ring and the zigzag ring, forward and backward
   against one causal flash call over the whole sequence (outputs within
   ``FWD_ATOL_BF16``, gradient rows within ``BWD_ROW_RTOL_BF16``), the
   fully masked hops exactly 0 with LSE -1e30, S^2 (3 S^2 for zigzag)
   hop forwards and as many of each backward kernel; then the host ms
   of warmed, uninstrumented passes of each.
25. train_tp_ep: GPT-base bf16 under ``gpt_tensor_parallel_rules`` on a
   (data=1, model=1) mesh against the same run without rules, and
   GPT-base-MoE (8 experts every 2nd block, capacity 1.25) top-1 and
   top-2 under ``moe_expert_parallel_rules`` on a (data=1, expert=1)
   mesh against the run without (3 eager steps, 2 windows, 4 timed
   replays): losses, masters, aux losses and flash launches bit for bit;
   the MoE runs (one batch every step) eagerly against replayed windows
   within WINDOW_RTOL, the loss falls, every aux loss finite and >= 1 -
   1e-5; one GPT-base block split over T = 2 and 4 virtual model ranks
   by the port's own cut (flash at 6 and 3 heads, the partial sums added
   here) and the MoE FFN over X = 2 and 4 virtual expert ranks, forward
   and every gradient in fp32 (PARITY_RTOL) and bf16 (the row check);
   step ms eager and replayed, peak memory (the rise above the
   allocation at each run's start, beside the process's peak), and one
   MoE FFN's routing, dispatch and combine against its products under
   ``torch.profiler``.
26. train_pipeline: PipelinedLM at GPT-base width (12 x 768, 12 heads,
   ff 3072, vocab 50257, untied head, no final LayerNorm, dense causal
   attention) bf16, B=8, L=1024, M=4 microbatches, GPipe (``rounds=1``)
   and circular (``rounds=2``, 6 layers a stage, ``remat=True``), each
   under ``pipeline_parallel_rules`` on a (data=1, stage=1) mesh against
   the same run without (3 eager steps, 2 windows, 4 timed replays):
   losses and masters bit for bit, windows captured, no flash launch;
   then S = 2 (``rounds=2``) and 4 (``rounds=1``) virtual stages of 3
   blocks in one process, fp32 and bf16, one forward and backward against
   the unsplit 12-block stack on the same microbatches (fp32 within
   PIPE_FP32_RTOL; bf16 within twice the unsplit bf16 stack's own error
   against fp32), with the ticks, stage applications and useful ones.
27. train_second_axis: GPT-base bf16 with the chunked head under oss,
   sddp and fsdp, each with an int8 ``rs_ag`` transport, on a (data=1,
   seq=1) mesh with ``shard_seq_dim=1`` against the same tier on the 1-D
   data mesh (4 eager steps, a window of 2 one-step windows, 2 timed
   replays): losses, masters, launches, the transport's bytes and
   residual bit for bit, a window captured, the flash and quantize pair
   launched; GPT-base under ``gpt_tensor_parallel_rules`` on a (data=1,
   model=1) mesh with fsdp, an int8 transport and the sharded format,
   emergency-saved after 2 steps and resumed by a fresh ``Stoke``, bit
   for bit against the uninterrupted run (the tag's bytes, save and load
   ms); then at GPT-base's widths in one process the chunked head over S
   = 2 and 4 virtual sequence shards against the unsharded one (fp32
   within SA_CE_RTOL, bf16 rows within ``BWD_ROW_RTOL_BF16``), and the
   transport's JAX-layout buckets of 2 virtual model ranks against the
   unsplit model's, with the quantize kernel's payload and scales, bit
   for bit.
28. train_three_axes: GPT-base-MoE under (data, model, expert) and the
   other three-axis meshes (its own function's docstring).
29. compile_audit: the compile cache, the program auditor and the
   autotuner. (a) two processes (``--cache-worker``) with
   ``CompileConfig`` on one directory: the first builds the five sources
   into ``<dir>/kernels`` inside its first program and misses each
   library, the second builds nothing, hits each, credits the first's
   build seconds and holds each kernel of the warm libraries against its
   plain version; a second ``Stoke`` in a process builds nothing. (b)
   GPT-base bf16, 3 eager steps, a window and 2 replays, without and with
   ``CompileConfig``: losses, the masters' digest, launches and dispatch
   counts bit for bit, eager and replayed p50, the first step's ms.
   (c) ``Stoke.audit()`` of that build and its ``serve`` engine (the
   serve trace): no findings, dispatch and launch counts unchanged, its
   seconds, the recorder's cost on a micro-step; a loss that calls
   ``.item()`` fires ``audit-hidden-transfer``. (d) the ``serve_decode``
   sweep of ``scripts/autotune_torch.py`` over the decode batch (8, 16,
   32 slots), its trials in this process: each trial's ``graph_ms`` and
   tokens/s, the winner persisted to a temporary ledger.

The two lines before the last are the kernels' summary and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s, and
# FLOP/s for the type the kernels' work is in. bf16 on the tensor cores.
# fp32-accurate products also run on the tensor cores, as three TF32
# products each (3xTF32), so fp32 work takes at least a third of the 495
# TFLOP/s TF32 rate; the 67 TFLOP/s of fp32 FMAs is not the least time the
# card can take for it
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12,
              torch.float16: 989e12}

FP32_ATOL = 1e-4  # kernel and plain version sum in different orders
SEED = 0
N_LAYERS, HEADS, HEAD_DIM = 12, 12, 64  # GPT "base"
VOCAB = 50257
TRAIN_BATCH, TRAIN_LEN = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 10
PARITY_RTOL = 1e-3  # kernels and dense attention sum in different orders
BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16
# kernels whose registers and spills the kernels phase reports: the fp32
# (3xTF32 mma.sync) flash kernels and the decode and verify kernels
TF32X3_KERNELS = ("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
FWD_TF32X3_KERNELS = ("flash_fwd_tf32x3_kernel",)
DECODE_KERNELS = ("paged_decode_chunk_kernel", "paged_decode_merge_kernel")
VERIFY_KERNELS = ("paged_verify_chunk_kernel", "paged_verify_merge_kernel")
# the 16-bit (bf16 and fp16) tensor-core flash kernels
QUANT_KERNELS = ("quantize_chunks_kernel", "dequantize_chunks_kernel")
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(0)}, power.limit unknown ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, each timed
    by CUDA events after a write that evicts the L2 cache (a serve step
    finds the previous layer's pages cold)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_usage(log: str, kernels) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported in
    ``log`` for each instantiation of ``kernels`` (names without the
    mangling), as ``{"<name><template args>": {"registers": n,
    "spill_stores": n, "spill_loads": n}}``, the arguments as ints, f32,
    bf16 and f16 (``"flash_fwd_tf32x3_kernel<64,4>"``,
    ``"flash_fwd_wgmma_kernel<f16,64>"``; a type repeated in the mangling
    as a back-reference ``S1_`` is the type before it)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(" + "|".join(kernels)
                      + r")I(\S*?)EEv", line)
        if m:
            args = []
            for n, bf, half, ref, _ in re.findall(
                    r"Li(\d+)E|(13__nv_bfloat16)|(6__half)|(S\d*_)|(f)",
                    m.group(2)):
                args.append(n or ("bf16" if bf else "f16" if half
                                  else args[-1] if ref else "f32"))
            cur = out.setdefault(f"{m.group(1)}<{','.join(args)}>", {})
        elif "Function properties" in line:
            cur = None
        elif cur is not None and "spill stores" in line:
            cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def allowed_pairs(B, L, mask, causal) -> float:
    """(query, key) pairs of one head summed over the batch that the key
    mask and the causal rule allow: the work these inputs need."""
    if mask is None:
        return float(B * (L * (L + 1) // 2 if causal else L * L))
    keys = mask.cumsum(1) if causal else mask.sum(1, keepdim=True) * L
    return float(keys.float().sum())


def padding_mask(B, L, dev):
    """Batch 0 masks key 0 (so under causal its query row 0 sees no key)
    and its last 37 keys; batch 1 masks every key."""
    mask = torch.ones(B, L, dtype=torch.int32, device=dev)
    mask[0, 0] = 0
    mask[0, L - 37:] = 0
    mask[1] = 0
    return mask


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def fwd_atol(ops, dtype) -> float:
    """The forward kernel's tolerance against its plain version."""
    return {FP32: FP32_ATOL, BF16: ops.FWD_ATOL_BF16,
            FP16: ops.FWD_ATOL_FP16}[dtype]


def check_flash(ops, gen, flush) -> list:
    """Flash forward at the prefill shapes (``FWD_SERVE_CASES``, fp32 and
    bf16), then ``FWD_BF16_CASES``, ``FWD_FP32_CASES`` and
    ``FWD_FP16_CASES``. fp32 runs the 3xTF32 ``mma.sync`` kernel, bf16 and
    fp16 the ``wgmma`` one's two instantiations."""
    cases = [flash_fwd_serve_case(ops, gen, flush, L, plen, dtype)
             for L, plen in FWD_SERVE_CASES for dtype in (FP32, BF16)]
    for dtype, fwd_cases in ((BF16, FWD_BF16_CASES), (FP32, FWD_FP32_CASES),
                             (FP16, FWD_FP16_CASES)):
        for case in fwd_cases:
            cases.append(flash_fwd_case(ops, gen, flush, *case, dtype=dtype))
    return cases


# the prefill shapes (L, prompt length): B=1, H=12, D=64, causal with a
# prompt-padding key mask; the L=64 case also masks key 0, which leaves
# query row 0 fully masked (LSE sentinel check)
FWD_SERVE_CASES = ((64, 41), (320, 301), (512, 400))


def flash_fwd_serve_case(ops, gen, flush, L, plen, dtype) -> dict:
    """The forward at a prefill shape against its plain version, timed
    beside SDPA, and as launches replayed from a CUDA graph (``graph_ms``:
    a call this small is mostly the wrapper's host work under
    ``time_ms``)."""
    dev = torch.device("cuda")
    q, k, v = (
        torch.randn(1, HEADS, L, HEAD_DIM, generator=gen,
                    device=dev).to(dtype)
        for _ in range(3)
    )
    mask = (torch.arange(L, device=dev) < plen).to(torch.int32)[None]
    sentinel = L == 64
    if sentinel:
        mask[0, 0] = 0
    out, lse = ops.flash_attention(q, k, v, mask, causal=True,
                                   return_lse=True)
    ref_out, ref_lse = ops.flash_attention_plain(q, k, v, mask, True)
    torch.cuda.synchronize()
    atol = fwd_atol(ops, dtype)
    err = max(max_err(out, ref_out), max_err(lse, ref_lse))
    if not (torch.isfinite(out).all() and err <= atol):
        raise AssertionError(
            f"flash_fwd L={L} {dtype}: max |kernel - plain| {err} > {atol}"
        )
    if sentinel and not (
        bool((lse[:, :, 0] == ops.NEG_INF).all())
        and bool((out[:, :, 0] == 0).all())
    ):
        raise AssertionError("flash_fwd: fully masked row 0 is not "
                             "O == 0, LSE == -1e30")
    # SDPA needs one boolean mask for causal and padding together
    allow = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
    allow = (allow & (mask[:, None, None, :] > 0))
    ms = time_ms(lambda: ops.flash_attention(q, k, v, mask, causal=True),
                 50, flush)
    plain_ms = time_ms(
        lambda: ops.flash_attention_plain(q, k, v, mask, True), 20, flush)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=allow), 50, flush)
    flops = 4.0 * HEAD_DIM * HEADS * allowed_pairs(1, L, mask, True)
    esize = q.element_size()
    n_bytes = (4 * L * HEADS * HEAD_DIM * esize  # q, k, v, o
               + 4 * L + 4 * HEADS * L)          # mask, lse
    b_ms, b_by = bound_ms(n_bytes, flops, dtype)
    return {
        "B": 1, "L": L, "D": HEAD_DIM, "causal": True, "masked": True,
        "prompt_len": plen,
        "dtype": str(dtype)[6:], "max_abs_err": err, "atol": atol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "graph_ms": graph_ms(lambda: ops.flash_attention(q, k, v, mask,
                                                         causal=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


# forward cases at B=8, H=12 (L, D, causal, masked), in bf16 and in fp32:
# the training path's shape first, then the kernels' other paths (L=1000
# is not a multiple of any tile)
FWD_BF16_CASES = ((TRAIN_LEN, HEAD_DIM, True, False),
                  (TRAIN_LEN, 128, True, False),
                  (1000, HEAD_DIM, True, False),
                  (TRAIN_LEN, HEAD_DIM, False, False),
                  (TRAIN_LEN, 128, True, True))
FWD_FP32_CASES = FWD_BF16_CASES
FWD_FP16_CASES = FWD_BF16_CASES


def flash_fwd_case(ops, gen, flush, L, D, causal, masked,
                   dtype=BF16) -> dict:
    """The forward at B=8, H=12, L, D in ``dtype`` against its plain
    version (``FWD_ATOL_BF16``, ``FWD_ATOL_FP16``, or ``FP32_ATOL`` for
    fp32), timed beside
    SDPA; ``masked`` applies ``padding_mask``, whose fully masked rows
    must give O == 0 and LSE == -1e30."""
    dev = torch.device("cuda")
    B = TRAIN_BATCH
    q, k, v = (torch.randn(B, HEADS, L, D, generator=gen,
                           device=dev).to(dtype) for _ in range(3))
    mask = padding_mask(B, L, dev) if masked else None
    out, lse = ops.flash_attention(q, k, v, mask, causal=causal,
                                   return_lse=True)
    ref_out, ref_lse = ops.flash_attention_plain(q, k, v, mask, causal)
    torch.cuda.synchronize()
    err = max(max_err(out, ref_out), max_err(lse, ref_lse))
    atol = fwd_atol(ops, dtype)
    name = (f"flash_fwd L={L} D={D} causal={causal} masked={masked} "
            f"{str(dtype)[6:]}")
    if not (torch.isfinite(out).all() and err <= atol):
        raise AssertionError(f"{name}: max |kernel - plain| {err} > {atol}")
    if masked:
        dead = [(out[1], lse[1])] + ([(out[0, :, 0], lse[0, :, 0])]
                                     if causal else [])
        if not all(bool((o == 0).all()) and bool((s == ops.NEG_INF).all())
                   for o, s in dead):
            raise AssertionError(f"{name}: fully masked rows are not O == 0, "
                                 f"LSE == -1e30")
    # SDPA takes the causal rule and the key mask as one boolean mask
    allow = None
    if masked:
        allow = mask[:, None, None, :] > 0
        if causal:
            allow = allow & torch.tril(torch.ones(L, L, dtype=torch.bool,
                                                  device=dev))
    pairs = HEADS * allowed_pairs(B, L, mask, causal)
    mask_bytes = 0 if mask is None else mask.numel() * 4
    b_ms, b_by = bound_ms(4 * q.numel() * q.element_size() + 4 * B * HEADS * L
                          + mask_bytes, 4.0 * D * pairs, dtype)
    return {
        "B": B, "L": L, "D": D, "causal": causal, "masked": masked,
        "prompt_len": None, "dtype": str(dtype)[6:],
        "max_abs_err": err, "atol": atol,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, mask,
                                                  causal=causal), 20, flush),
        "plain_ms": time_ms(lambda: ops.flash_attention_plain(
            q, k, v, mask, causal), 5, flush),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=allow, is_causal=causal and not masked),
            20, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def decode_inputs(gen, pool_dtype, D=HEAD_DIM, q_dtype=FP32, last_ctx=432,
                  first_ctx=1):
    """Decode inputs at the serve path's shapes: B=8 slots, H=12, D=64,
    16-token pages, 32-entry tables over the engine's pool of 8*32+1
    blocks; contexts from 17 to 480, the last slot's ``last_ctx`` (by
    default 432, the serve trace's longest decode context), slot 0 at
    ``first_ctx`` on an all-scratch table (1: an inactive slot); unused
    entries on scratch block 0."""
    dev = torch.device("cuda")
    B, BS, MB = 8, 16, 32
    NB = B * MB + 1
    ctx = torch.tensor([first_ctx, 17, 64, 129, 250, 333, 480, last_ctx],
                       dtype=torch.int32, device=dev)
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32, device=dev)
    for b in range(1, B):
        n = -(-int(ctx[b]) // BS)
        tables[b, :n] = perm[b * MB : b * MB + n]
    q = torch.randn(B, HEADS, 1, D, generator=gen, device=dev).to(q_dtype)
    k_pages = torch.randn(NB, BS, HEADS, D, generator=gen,
                          device=dev).to(pool_dtype)
    v_pages = torch.randn(NB, BS, HEADS, D, generator=gen,
                          device=dev).to(pool_dtype)
    return q, k_pages, v_pages, tables, ctx


# decode cases (pool dtype, q dtype, D, last slot's context, slot 0's
# context): the serve path's shapes with an fp32 and a bf16 pool, then
# D=128, bf16 queries over a bf16 pool, a slot at context 512 (the table's
# last position), and slot 0 at context 0, which the kernel gives exactly 0
DECODE_CASES = ((FP32, FP32, HEAD_DIM, 432, 1),
                (BF16, FP32, HEAD_DIM, 432, 1),
                (FP32, FP32, 128, 432, 1),
                (BF16, BF16, HEAD_DIM, 432, 1),
                (FP32, FP32, HEAD_DIM, 512, 1),
                (FP32, FP32, HEAD_DIM, 432, 0))


def check_decode(ops, gen, flush) -> list:
    """The decode kernels against ``paged_decode_attention`` on
    ``DECODE_CASES``; a slot at context 0 against exact zeros (the plain
    version gives it the mean of V, as the JAX package's jnp reference
    does). No single PyTorch call computes a paged gather under a length
    mask, so there is no library time."""
    cases = []
    for pool_dtype, q_dtype, D, last_ctx, first_ctx in DECODE_CASES:
        args = decode_inputs(gen, pool_dtype, D, q_dtype, last_ctx,
                             first_ctx)
        q, kp, _, tables, ctx = args
        out = ops.paged_decode_attention_pallas(*args)
        ref = ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        atol = (FP32_ATOL if pool_dtype == FP32 and q_dtype == FP32
                else ops.FWD_ATOL_BF16)
        empty = ctx == 0
        err = max_err(out[~empty], ref[~empty])
        name = (f"paged_decode pool {pool_dtype} q {q_dtype} D={D} "
                f"contexts {[int(c) for c in ctx]}")
        if not (torch.isfinite(out).all() and err <= atol):
            raise AssertionError(f"{name}: max |kernel - plain| {err} > "
                                 f"{atol}")
        if out[empty].count_nonzero():
            raise AssertionError(f"{name}: a slot at context 0 is not 0")

        def kernel():
            return ops.paged_decode_attention_pallas(*args)

        ms = time_ms(kernel, 100, flush)
        plain_ms = time_ms(lambda: ops.paged_decode_attention(*args), 20,
                           flush)
        tokens = float(ctx.clamp(0, tables.shape[1] * kp.shape[1]).sum())
        n_bytes = (2 * tokens * HEADS * D * kp.element_size()
                   + 2 * q.numel() * q.element_size()
                   + tables.numel() * 4 + ctx.numel() * 4)
        flops = 4.0 * D * HEADS * tokens
        b_ms, b_by = bound_ms(n_bytes, flops, FP32)
        cases.append({
            "B": q.shape[0], "D": D, "pool_dtype": str(pool_dtype)[6:],
            "q_dtype": str(q_dtype)[6:],
            "context_lens": [int(c) for c in ctx], "max_abs_err": err,
            "atol": atol, "zero_slots": int(empty.sum()), "ms": ms,
            "graph_ms": graph_ms(kernel), "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        })
    return cases


def verify_inputs(gen, pool_dtype, D=HEAD_DIM, S=5, q_dtype=FP32,
                  last_ctx=509):
    """Verify inputs at the speculative serve path's shapes: B=8 slots,
    H=12, S=5 (speculative_k=4), D=64, 16-token pages, 32-entry tables
    over the engine's pool of 8*32+1 blocks. Slot 0 is idle (positions
    0..S-1 on an all-scratch table); the others verify at contexts from 17
    to ``last_ctx``, positions clamped to 511 as the scheduler clamps
    short drafts' padding rows at max_seq_len - 1."""
    dev = torch.device("cuda")
    B, BS, MB = 8, 16, 32
    NB = B * MB + 1
    ctx = [0, 17, 64, 129, 250, 333, 480, last_ctx]
    positions = torch.tensor(
        [[s if b == 0 else min(c + s, MB * BS - 1) for s in range(S)]
         for b, c in enumerate(ctx)], dtype=torch.int32, device=dev)
    perm = torch.randperm(NB - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros(B, MB, dtype=torch.int32, device=dev)
    for b in range(1, B):
        n = -(-int(positions[b].max() + 1) // BS)
        tables[b, :n] = perm[b * MB : b * MB + n]
    q = torch.randn(B, HEADS, S, D, generator=gen, device=dev).to(q_dtype)
    k_pages = torch.randn(NB, BS, HEADS, D, generator=gen,
                          device=dev).to(pool_dtype)
    v_pages = torch.randn(NB, BS, HEADS, D, generator=gen,
                          device=dev).to(pool_dtype)
    return q, k_pages, v_pages, tables, positions


# verify cases (pool dtype, q dtype, D, S, last slot's context): the serve
# path's shapes with an fp32 and a bf16 pool, then D=128, S=16
# (speculative_k=15), bf16 queries over a bf16 pool, and a slot whose
# pending token sits at position 511, the table's last
VERIFY_CASES = ((FP32, FP32, HEAD_DIM, 5, 509),
                (BF16, FP32, HEAD_DIM, 5, 509),
                (FP32, FP32, 128, 5, 509),
                (FP32, FP32, HEAD_DIM, 16, 511),
                (BF16, BF16, HEAD_DIM, 5, 511))


def graph_ms(fn, n: int = 50) -> float:
    """Device ms per call of ``fn`` over ``n`` calls captured in one CUDA
    graph and replayed between one event pair: the kernels' time without
    the wrapper's host work between them, which ``time_ms``'s per-call
    events cannot separate from a kernel of tens of microseconds. The L2
    is not flushed between the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_verify(ops, gen, flush) -> list:
    """The verify kernels against ``paged_verify_attention`` on
    ``VERIFY_CASES``. No single PyTorch call computes a paged gather with
    a per-query positional mask, so there is no library time."""
    cases = []
    for pool_dtype, q_dtype, D, S, last_ctx in VERIFY_CASES:
        q, kp, vp, tables, positions = verify_inputs(gen, pool_dtype, D, S,
                                                     q_dtype, last_ctx)
        out = ops.paged_verify_attention_pallas(q, kp, vp, tables, positions)
        ref = ops.paged_verify_attention(q, kp, vp, tables, positions)
        torch.cuda.synchronize()
        atol = (FP32_ATOL if pool_dtype == FP32 and q_dtype == FP32
                else ops.FWD_ATOL_BF16)
        err = max_err(out, ref)
        name = (f"paged_verify pool {pool_dtype} q {q_dtype} D={D} S={S} "
                f"last context {last_ctx}")
        if not (torch.isfinite(out).all() and err <= atol):
            raise AssertionError(f"{name}: max |kernel - plain| {err} > "
                                 f"{atol}")

        def kernel():
            return ops.paged_verify_attention_pallas(q, kp, vp, tables,
                                                     positions)

        ms = time_ms(kernel, 100, flush)
        plain_ms = time_ms(lambda: ops.paged_verify_attention(
            q, kp, vp, tables, positions), 20, flush)
        # K/V up to each slot's last visible position, q and out
        tokens = float((positions.max(dim=1).values + 1).sum())
        n_bytes = (2 * tokens * HEADS * D * kp.element_size()
                   + 2 * q.numel() * q.element_size()
                   + tables.numel() * 4 + positions.numel() * 4)
        flops = 4.0 * S * D * HEADS * tokens
        b_ms, b_by = bound_ms(n_bytes, flops, FP32)
        cases.append({
            "B": q.shape[0], "S": S, "D": D,
            "pool_dtype": str(pool_dtype)[6:], "q_dtype": str(q_dtype)[6:],
            "last_positions": [int(p) for p in positions.max(dim=1).values],
            "max_abs_err": err, "atol": atol, "ms": ms,
            "graph_ms": graph_ms(kernel), "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        })
    return cases


def sdpa_backward_ms(q, k, v, do, causal, flush, attn_mask=None) -> float:
    """SDPA's backward alone, timed with the L2 flushed (the library
    yardstick; the port never calls it): one forward outside the timer,
    then ``torch.autograd.grad`` of its output captured in a CUDA graph
    and replayed, so the events time the library's kernels and not the
    card waiting for autograd's host work. ``attn_mask``: SDPA's boolean
    mask (True = attend), for a non-causal masked case."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # the backward runs on its forward's stream: the capture stream
        o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=attn_mask, is_causal=causal)
        for _ in range(3):
            torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    return time_ms(graph.replay, 10, flush)


# backward cases at B=8, H=12 (L, dtype, D, causal, masked): the training
# shapes in fp32 and bf16, padding masks with fully masked rows, and both
# dtypes' tensor-core kernels' other paths (D=128, a ragged L=1000, no
# causal rule)
BWD_CASES = ((512, FP32, HEAD_DIM, True, False),
             (512, BF16, HEAD_DIM, True, False),
             (TRAIN_LEN, FP32, HEAD_DIM, True, False),
             (TRAIN_LEN, BF16, HEAD_DIM, True, False),
             (512, FP32, HEAD_DIM, True, True),
             (512, BF16, HEAD_DIM, True, True),
             (TRAIN_LEN, FP32, 128, True, False),
             (1000, FP32, HEAD_DIM, True, False),
             (TRAIN_LEN, FP32, HEAD_DIM, False, False),
             (TRAIN_LEN, BF16, 128, True, False),
             (1000, BF16, HEAD_DIM, True, False),
             (TRAIN_LEN, BF16, HEAD_DIM, False, False),
             (512, BF16, 128, True, True))
# fp16 gradients under the loss scale: dO of N(0, 2^-10) (eight times a
# mean cross entropy's over the 8192 tokens of a training batch) times the
# scale fp16 starts at, 2^16; and dO of N(0, 2^-13), whose largest |dS| is
# the order of the GPT-base fp16 step's (train_fp16's max_abs_ds), most of
# dS below fp16's smallest normal, 6.1e-5 (the kernels scale dS by a power
# of two before rounding it: ds_bound)
DO_SCALED = 2.0**-10 * 2.0**16
DO_STEP = 2.0**-13
# fp16 cases (L, dtype, D, causal, masked, dO scale): the bf16 cases'
# paths, then the training shape with dO scaled as above
BWD_FP16_CASES = ((TRAIN_LEN, FP16, HEAD_DIM, True, False, 1.0),
                  (512, FP16, HEAD_DIM, True, True, 1.0),
                  (TRAIN_LEN, FP16, 128, True, False, 1.0),
                  (1000, FP16, HEAD_DIM, True, False, 1.0),
                  (TRAIN_LEN, FP16, HEAD_DIM, False, False, 1.0),
                  (TRAIN_LEN, FP16, HEAD_DIM, True, False, DO_SCALED),
                  (TRAIN_LEN, FP16, HEAD_DIM, True, False, DO_STEP))


def check_flash_bwd(ops, gen, flush) -> list:
    """The dQ and dK/dV kernels against ``flash_attention_bwd_plain`` on
    ``BWD_CASES`` and ``BWD_FP16_CASES``: bf16 and fp16 run the ``wgmma``
    kernels, fp32 the 3xTF32 ``mma.sync`` ones. Then a bf16 dQ call at head dim 96, which no kernel
    takes: the wrapper must raise and the C entry return
    ``kErrUnsupported``."""
    cases = [flash_bwd_case(ops, gen, flush, *case)
             for case in BWD_CASES + BWD_FP16_CASES]
    x = torch.zeros(1, 1, 64, 96, dtype=BF16, device="cuda")
    stats = torch.zeros(1, 1, 64, device="cuda")
    try:
        ops.flash_bwd_dq(x, x, x, None, x, stats, stats, True)
    except ValueError:
        pass
    else:
        raise AssertionError("a bf16 dQ call at head dim 96 did not raise")
    # the C entry itself refuses the head dim: kErrUnsupported, no fallback
    fa = importlib.import_module("stoke_tpu_torch.ops.flash_attention")
    fn, _ = fa._kernel("flash_bwd_dq", [fa._P] * 9 + [fa._I] * 5
                       + [ctypes.c_float, fa._I, fa._P], source="flash_bwd")
    rc = fn(*(t.data_ptr() for t in (x, x, x, x, stats, stats)), None, None,
            x.data_ptr(), 1, 1, 64, 96, 1, 96 ** -0.5, 1,
            fa._stream_ptr(x.device))
    if rc != -1:
        raise AssertionError(f"stoke_flash_bwd_dq at bf16, head dim 96 "
                             f"returned {rc}, expected -1 (unsupported)")
    return cases


def max_abs_ds(q, k, v, mask, out, lse, do, causal) -> float:
    """The largest |dS| = |P (dO V^T - delta)| of these inputs, in fp32:
    what the 16-bit backward kernels round to their type before ``dS K``
    and ``dS^T Q`` (fp16 holds at most 65504)."""
    fa = importlib.import_module("stoke_tpu_torch.ops.flash_attention")
    s = fa._masked_scores(q, k, mask, causal)
    p = torch.where(s > fa.NEG_INF * 0.5, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    del s
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    dp -= fa._delta(out, do, None)[..., None]
    return float((p * dp).abs().max())


def flash_bwd_case(ops, gen, flush, L, dtype, D, causal, masked,
                   do_scale=1.0) -> dict:
    """One backward case: dQ and dK/dV within FP32_ATOL (fp32) or
    BWD_RTOL_BF16 of the largest gradient element (bf16 and fp16), bf16
    and fp16 dQ, dK and dV also within BWD_ROW_RTOL_BF16 row by row
    (``bwd_row_err``); under ``padding_mask`` the fully masked query rows
    get zero dQ and the masked keys zero dK, dV. dO is N(0, 1) times
    ``do_scale``; fp16 cases report the largest |dS| (``max_abs_ds``) and
    the power of two the kernels scaled dS by (``ds_scale``).
    Timed beside the plain version and SDPA's backward."""
    dev = torch.device("cuda")
    B = TRAIN_BATCH
    q, k, v, do = (torch.randn(B, HEADS, L, D, generator=gen,
                               device=dev) for _ in range(4))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do * do_scale))
    mask = padding_mask(B, L, dev) if masked else None
    out, lse = ops.flash_attention(q, k, v, mask, causal=causal,
                                   return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    # fp16: the |dS| bound, computed once a layer for both kernels
    bound = ops.ds_bound(do, v, delta) if dtype == FP16 else None
    dq = ops.flash_bwd_dq(q, k, v, mask, do, lse, delta, causal, bound)
    dk, dv = ops.flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal, bound)
    ref = ops.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, None,
                                        causal)
    torch.cuda.synchronize()
    name = (f"flash_bwd L={L} D={D} {dtype} causal={causal} "
            f"masked={masked} dO x {do_scale}")
    errs = {n: max_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                (dq, dk, dv), ref)}
    row_errs = None
    if dtype == torch.float32:
        tols = {n: FP32_ATOL for n in errs}
    else:
        tols = {n: ops.BWD_RTOL_BF16 * float(r.float().abs().max())
                for n, r in zip(errs, ref)}
        row_errs = {n: ops.bwd_row_err(a, b)
                    for n, a, b in zip(errs, (dq, dk, dv), ref)}
    finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    if not finite or any(errs[n] > tols[n] for n in errs):
        raise AssertionError(f"{name}: max |kernel - plain| {errs} over "
                             f"{tols} (finite: {finite})")
    if row_errs and max(row_errs.values()) > ops.BWD_ROW_RTOL_BF16:
        raise AssertionError(f"{name}: a row's |kernel - plain| over "
                             f"|plain| (floored) is {row_errs} > "
                             f"{ops.BWD_ROW_RTOL_BF16}")
    if masked and not (bool((dq[1] == 0).all())
                       and (not causal or bool((dq[0, :, 0] == 0).all()))
                       and bool((dk[1] == 0).all())
                       and bool((dv[1] == 0).all())
                       and bool((dk[0, :, L - 37:] == 0).all())
                       and bool((dv[0, :, L - 37:] == 0).all())):
        raise AssertionError(f"{name}: fully masked rows are not zero dQ / "
                             f"zero dK, dV")
    ms_dq = time_ms(lambda: ops.flash_bwd_dq(q, k, v, mask, do, lse, delta,
                                             causal, bound), 10, flush)
    ms_dkv = time_ms(lambda: ops.flash_bwd_dkv(q, k, v, mask, do, lse, delta,
                                               causal, bound), 10, flush)
    plain_ms = time_ms(lambda: ops.flash_attention_bwd_plain(
        q, k, v, mask, out, lse, do, None, causal), 5, flush)
    library_ms = (None if masked
                  else sdpa_backward_ms(q, k, v, do, causal, flush))
    pairs = HEADS * allowed_pairs(B, L, mask, causal)
    tile = B * HEADS * L * D * q.element_size()  # one [B, H, L, D] tensor
    stats = 2 * B * HEADS * L * 4  # lse, delta
    mask_bytes = 0 if mask is None else mask.numel() * 4
    # dq: S, dP, dQ products (2 FLOPs per multiply-add each); reads q, k,
    # v, dO, lse, delta, writes dQ. dkv: S, dV, dP, dK; writes dK, dV. The
    # pair: the same plus O (for delta).
    bq = bound_ms(5 * tile + stats + mask_bytes, 6.0 * D * pairs, dtype)
    bkv = bound_ms(6 * tile + stats + mask_bytes, 8.0 * D * pairs, dtype)
    bpair = bound_ms(8 * tile + stats + mask_bytes, 14.0 * D * pairs, dtype)
    return {
        "B": B, "L": L, "D": D, "dtype": str(dtype)[6:], "causal": causal,
        "masked": masked, "do_scale": do_scale,
        "max_abs_ds": (max_abs_ds(q, k, v, mask, out, lse, do, causal)
                       if dtype == FP16 else None),
        "ds_scale": None if bound is None else ops.ds_scale(float(bound)),
        "ds_bound_ms": (None if bound is None else time_ms(
            lambda: ops.ds_bound(do, v, delta), 10, flush)),
        "max_abs_err": errs, "tol": tols, "row_rel_err": row_errs,
        "dq_ms": ms_dq, "dkv_ms": ms_dkv, "pair_ms": ms_dq + ms_dkv,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "dq_bound_ms": bq[0], "dq_bound_by": bq[1],
        "dkv_bound_ms": bkv[0], "dkv_bound_by": bkv[1],
        "pair_bound_ms": bpair[0], "pair_bound_by": bpair[1],
    }


#: the quantize pair's cases: a 25 MB fp32 bucket (``CommConfig``'s
#: default ``bucket_mb``) and GPT-base's whole gradient; (elements, chunk,
#: stochastic); a count that is not a multiple of the chunk leaves a
#: ragged last chunk, zero-padded as the transports and the serving store
#: pad it
QUANT_BUCKET = 25 * 2**20 // 4
QUANT_FULL = 124_439_808
QUANT_CASES = ((QUANT_BUCKET, 512, True), (QUANT_BUCKET, 128, False),
               (QUANT_BUCKET - 300, 512, True), (QUANT_FULL, 512, True),
               (QUANT_FULL, 128, False))
#: the bucket's index and the rank's fold, as a rank's second stage folds
#: them into the step's key
QUANT_FOLDS = (3, 1)


def quant_case(ops, gen, flush, n: int, chunk: int, stochastic: bool) -> dict:
    """The quantize and dequantize kernels on ``n`` heavy-tailed elements
    (padded with zeros to the chunk) against their plain versions bit for
    bit: the plain version runs a bucket at a time (its counter offset
    the bucket's start), so a whole gradient is held to it piece by
    piece. Times by events after an L2 flush (``ms``), replayed from a
    CUDA graph (``graph_ms``), the plain version's over the same
    elements, and the least time the bytes allow (read fp32 and write
    int8 plus a scale a chunk, or the reverse)."""
    padded = -(-n // chunk) * chunk
    x = torch.zeros(padded, device="cuda")
    x[:n] = (torch.randn(n, device="cuda", generator=gen)
             * torch.randn(n, device="cuda", generator=gen).exp())
    key = torch.tensor([0, 7], dtype=torch.int64, device="cuda")
    kw = dict(key=key, stochastic=stochastic, folds=QUANT_FOLDS)
    q, sc = ops.quantize_chunks(x, chunk, **kw)
    deq = ops.dequantize_chunks(q, sc, chunk, FP32, n)
    deq16 = ops.dequantize_chunks(q, sc, chunk, BF16, n)
    bad_q = bad_s = 0
    err = err16 = q_err = 0.0

    def plain_pieces(check: bool):
        nonlocal bad_q, bad_s, err, err16, q_err
        for lo in range(0, padded, QUANT_BUCKET):
            hi = min(lo + QUANT_BUCKET, padded)
            pq, ps = ops.quantize_chunks_plain(x[lo:hi], chunk, offset=lo,
                                               **kw)
            if not check:
                continue
            bad_q += int((pq != q[lo:hi]).sum())
            bad_s += int((ps != sc[lo // chunk:hi // chunk]).sum())
            # payload in levels, scales in fp32
            q_err = max(q_err, max_err(pq, q[lo:hi]),
                        max_err(ps, sc[lo // chunk:hi // chunk]))
            m = min(hi, n) - lo
            pd = ops.dequantize_chunks_plain(pq, ps, chunk, FP32, m)
            err = max(err, max_err(pd, deq[lo:lo + m]))
            err16 = max(err16, max_err(ops.dequantize_chunks_plain(
                pq, ps, chunk, BF16, m), deq16[lo:lo + m]))

    plain_pieces(True)
    torch.cuda.synchronize()
    if bad_q or bad_s or err or err16:
        raise AssertionError(
            f"quantize n={n} chunk={chunk} stochastic={stochastic}: "
            f"{bad_q} payload and {bad_s} scale mismatches, dequantize "
            f"errors {err} (fp32) {err16} (bf16) against the plain version")
    big = n > QUANT_BUCKET
    iters, reps = (5, 10) if big else (20, 50)
    q_bytes = 4 * padded + padded + 4 * padded // chunk
    d_bytes = padded + 4 * padded // chunk + 4 * n
    out = {"n": n, "padded": padded, "chunk": chunk,
           "stochastic": stochastic, "folds": list(QUANT_FOLDS),
           "payload_mismatches": bad_q, "scale_mismatches": bad_s,
           "quantize_max_abs_err": q_err,
           "max_abs_err": err, "bf16_max_abs_err": err16}
    for name, fn, nbytes in (
            ("quantize", lambda: ops.quantize_chunks(x, chunk, **kw),
             q_bytes),
            ("dequantize",
             lambda: ops.dequantize_chunks(q, sc, chunk, FP32, n), d_bytes)):
        b, by = bound_ms(nbytes, 0.0, FP32)
        out[name] = {"ms": time_ms(fn, iters, flush),
                     "graph_ms": graph_ms(fn, reps), "bound_ms": b,
                     "bound_by": by, "bytes": nbytes}
    # the plain versions over the same elements, a bucket at a time
    out["quantize"]["plain_ms"] = time_ms(lambda: plain_pieces(False), 1,
                                          flush)
    out["dequantize"]["plain_ms"] = time_ms(
        lambda: [ops.dequantize_chunks_plain(
            q[lo:lo + QUANT_BUCKET], sc[lo // chunk:(lo + QUANT_BUCKET)
                                        // chunk], chunk, FP32)
            for lo in range(0, padded, QUANT_BUCKET)], 1, flush)
    return out


def check_quant(ops, gen, flush) -> list:
    """QUANT_CASES through :func:`quant_case`; a dequantize launch
    refused for a payload that is not a whole number of chunks must
    raise in the wrapper."""
    cases = []
    for n, chunk, stochastic in QUANT_CASES:
        cases.append(quant_case(ops, gen, flush, n, chunk, stochastic))
        torch.cuda.empty_cache()
    bad = torch.zeros(130, dtype=torch.int8, device="cuda")
    try:
        ops.dequantize_chunks(bad, torch.ones(1, device="cuda"), 128)
    except ValueError:
        pass
    else:
        raise AssertionError("dequantize_chunks took 130 elements for one "
                             "chunk of 128")
    return cases


# --------------------------------------------------------------------------- #
# phase 4: serve GPT-base through the kernels
# --------------------------------------------------------------------------- #


SERVE = dict(max_seqs=8, kv_block_size=16, max_seq_len=512,
             prefill_pad_multiple=64, max_new_tokens=32)


def drive(engine, prompts) -> tuple:
    """Submit ``prompts`` in three waves (8 up front, 4 after 4 steps, 4
    after 12) and run until drained. Returns (streams, wall seconds)."""
    t0 = time.perf_counter()
    rids = [engine.submit(p) for p in prompts[:8]]
    for _ in range(4):
        engine.step()
    rids += [engine.submit(p) for p in prompts[8:12]]
    for _ in range(8):
        engine.step()
    rids += [engine.submit(p) for p in prompts[12:]]
    engine.run()
    wall = time.perf_counter() - t0
    return [list(engine.result(r).tokens) for r in rids], wall


def top2_gap(model, prompt, prefix) -> float:
    """Top-1 minus top-2 logit of the next token after prompt + prefix, by
    the model's full-sequence forward (dense attention)."""
    ids = torch.tensor([list(prompt) + list(prefix)], device="cuda")
    with torch.inference_mode():
        logits = model(ids)[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def serve(ops) -> dict:
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = model.state_dict()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, model.vocab_size, size=int(n)) for n in lens]
    kern_cfg = ServeConfig(attention="flash", decode_kernel="pallas", **SERVE)
    plain_cfg = ServeConfig(attention="dense", decode_kernel="reference",
                            **SERVE)

    # warm the allocator and the matmul libraries outside the measured run
    ServingEngine(model, weights, kern_cfg).generate([prompts[0][:16]], 2)

    engine = ServingEngine(model, weights, kern_cfg)
    ops.reset_launches()
    streams, wall = drive(engine, prompts)
    launches = dict(ops.LAUNCHES)
    summary = engine.summary()
    steps, prefills = summary["decode_steps"], summary["prefills"]
    if not (launches["flash_fwd"] and launches["paged_decode"]):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{launches}")
    if launches["paged_decode"] != N_LAYERS * steps:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times, "
            f"expected {N_LAYERS} x {steps} decode steps"
        )
    if launches["flash_fwd"] != N_LAYERS * prefills:
        raise AssertionError(
            f"flash_fwd launched {launches['flash_fwd']} times, expected "
            f"{N_LAYERS} x {prefills} prefills"
        )
    if [len(s) for s in streams] != [SERVE["max_new_tokens"]] * 16:
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")

    plain = ServingEngine(model, weights, plain_cfg)
    plain_streams, plain_wall = drive(plain, prompts)
    diverged = []
    for i, (a, b) in enumerate(zip(streams, plain_streams)):
        if a == b:
            continue
        j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = top2_gap(model, prompts[i], a[:j])
        diverged.append({"request": i, "token": j, "top2_gap": gap})
        if gap > 1e-3:
            raise AssertionError(
                f"request {i} diverges from the plain path at token {j} "
                f"with top-2 logit gap {gap} > 1e-3"
            )
    # the decode kernels' device time and the card's busy share, over one
    # more drive of the checked configuration
    profiled = profile_drive(ServingEngine(model, weights, kern_cfg), prompts,
                             "decode")
    return {
        "phase": "serve", "model": "GPT-base (12 x 768, 12 heads, ff 3072, "
        "vocab 50257), fp32, seeded random weights",
        "requests": 16, "prompt_lens": [int(n) for n in lens],
        "tokens_out": summary["tokens_out"], "wall_s": wall,
        "tokens_per_s": summary["tokens_out"] / wall,
        "ttft_p50_s": summary["ttft_p50_s"],
        "ttft_p99_s": summary["ttft_p99_s"],
        "tpot_p50_s": summary["tpot_p50_s"],
        "tpot_p99_s": summary["tpot_p99_s"],
        "decode_steps": steps, "prefills": prefills, "launches": launches,
        "plain_path_wall_s": plain_wall,
        "streams_equal_plain": 16 - len(diverged), "diverged": diverged,
        "profile": profiled,
    }


# --------------------------------------------------------------------------- #
# phase 5: speculative serving with sampling and chunked prefill
# --------------------------------------------------------------------------- #


SPEC = dict(attention="flash", decode_kernel="pallas", sampling=True,
            prefill_chunk_tokens=128, **SERVE)
SPEC_K = 4
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, sampling_seed=1234)
LOGITS_ATOL = 1e-3  # verify and decode forwards sum in different orders


def requote_prompts(rng, vocab, n=16):
    """Prompt-lookup traffic: each prompt (16 to 400 tokens) is a random
    8-32-token segment repeated, then a random tail of 1-8 tokens."""
    prompts = []
    for length in rng.integers(16, 401, size=n):
        seg = rng.integers(0, vocab, size=int(rng.integers(8, 33)))
        tail = int(rng.integers(1, 9))
        body = np.tile(seg, -(-int(length) // seg.size))[: int(length) - tail]
        prompts.append(np.concatenate([body, rng.integers(0, vocab, tail)]))
    return prompts


def first_divergence(a, b):
    return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)


def sampler_ms(flush) -> float:
    """Card time of one ``speculative_sample_tokens`` at the verify path's
    shapes (B=8, S=5, V=50257, knobs of the sampled run), from host key
    data as the engine holds it (the splits run on the host, the draws on
    the card)."""
    from stoke_tpu_torch.serving import sampling

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    logits = torch.randn(8, SPEC_K + 1, VOCAB, generator=gen, device="cuda")
    kd = np.stack([sampling.initial_key_data(i) for i in range(8)])
    knobs = (torch.full((8,), SAMPLED["temperature"], device="cuda"),
             torch.full((8,), SAMPLED["top_k"], dtype=torch.int32,
                        device="cuda"),
             torch.full((8,), SAMPLED["top_p"], device="cuda"))
    return time_ms(lambda: sampling.speculative_sample_tokens(
        logits, kd, *knobs), 20, flush)


def host_ms(prompts, streams) -> dict:
    """Host milliseconds of a verify step's two host-side pieces at the
    serve_spec shapes: the five sequential key splits of 8 slots (numpy),
    and the prompt-lookup drafts of 8 slots over their whole histories
    (prompt + 32 tokens), each averaged over repeated calls."""
    from stoke_tpu_torch.serving.sampling import initial_key_data, split_chain
    from stoke_tpu_torch.serving.speculative import propose_draft

    kd = np.stack([initial_key_data(i) for i in range(8)])
    t0 = time.perf_counter()
    for _ in range(50):
        split_chain(kd, SPEC_K + 1)
    split = (time.perf_counter() - t0) / 50 * 1e3
    histories = [np.concatenate([p, np.asarray(t, np.int32)])
                 for p, t in zip(prompts[:8], streams[:8])]
    t0 = time.perf_counter()
    for _ in range(20):
        for h in histories:
            propose_draft(h, SPEC_K, ngram_max=3, ngram_min=1)
    draft = (time.perf_counter() - t0) / 20 * 1e3
    return {"split_chain_8_slots": split, "propose_draft_8_slots": draft,
            "history_lens": [int(h.size) for h in histories]}


def profile_drive(engine, prompts, op: str) -> dict:
    """Device time by CUDA kernel over one more drive of ``engine``
    (``torch.profiler``; user annotations left out), against its host
    wall time: the card's busy share of a serve run; and the ``paged_<op>``
    kernels' device ms per launch of the wrapper (``op`` "decode" or
    "verify": a chunk kernel, launched once a call, and, where a slot's
    walk may span chunks, a merge kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = drive(engine, prompts)
        torch.cuda.synchronize()
    rows = sorted(
        ((getattr(e, "self_device_time_total", 0.0) / 1e3, e.key, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        reverse=True)
    if not rows:
        return {"wall_ms": wall * 1e3, "device_ms": "not measured"}
    device_ms = sum(r[0] for r in rows)
    s = engine.summary()
    paged = [r for r in rows if f"paged_{op}" in r[1]]
    launches = max((c for _, _, c in paged), default=0)
    return {
        "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "launches": sum(r[2] for r in rows),
        f"{op}_dispatches": s["decode_steps"],
        f"{op}_kernels": [{"name": n[:90], "calls": c, "ms": ms}
                          for ms, n, c in paged],
        f"{op}_ms_per_launch": (sum(r[0] for r in paged) / launches
                                if launches else "not measured"),
        "goodput_s": s["goodput_s"],
        "top": [{"name": n[:90], "calls": c, "ms": ms}
                for ms, n, c in rows[:12]],
    }


def serve_spec(ops) -> dict:
    """GPT-base (fp32, seeded random weights) through the speculative
    engine (verify kernel, sampling, packed chunked prefill), greedy and
    sampled, each against the same config without speculation."""
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = model.state_dict()
    prompts = requote_prompts(np.random.default_rng(SEED + 1),
                              model.vocab_size)
    ServingEngine(model, weights, ServeConfig(**SPEC, speculative_k=SPEC_K)
                  ).generate([prompts[0][:16]], 4)  # warm the libraries

    def run_engine(knobs, k):
        return ServingEngine(model, weights,
                             ServeConfig(**SPEC, **knobs, speculative_k=k))

    def run(knobs, k, capture):
        engine = run_engine(knobs, k)
        engine.capture_logits = capture
        ops.reset_launches()
        streams, wall = drive(engine, prompts)
        return engine, streams, wall, dict(ops.LAUNCHES)

    report = {"phase": "serve_spec", "model": "GPT-base (12 x 768, 12 heads, "
              "ff 3072, vocab 50257), fp32, seeded random weights",
              "config": {**SPEC, "speculative_k": SPEC_K},
              "sampled_knobs": SAMPLED, "requests": len(prompts),
              "prompt_lens": [int(p.size) for p in prompts]}
    for mode, knobs in (("greedy", {}), ("sampled", SAMPLED)):
        # timed runs with no logits fetched; then both again with the
        # pre-sampling logits captured for the comparison
        engine, streams, wall, launches = run(knobs, SPEC_K, False)
        plain, plain_streams, plain_wall, plain_launches = run(knobs, None,
                                                               False)
        s, m, ps = engine.summary(), engine.metrics, plain.summary()
        dispatches = s["decode_steps"]
        if launches["paged_verify"] != N_LAYERS * dispatches:
            raise AssertionError(
                f"{mode}: paged_verify launched {launches['paged_verify']} "
                f"times, expected {N_LAYERS} x {dispatches} verify dispatches")
        if launches["paged_decode"]:
            raise AssertionError(f"{mode}: the speculative engine launched "
                                 f"the decode kernel: {launches}")
        if launches["flash_fwd"] != N_LAYERS * s["prefills"]:
            raise AssertionError(
                f"{mode}: flash_fwd launched {launches['flash_fwd']} times, "
                f"expected {N_LAYERS} x {s['prefills']} whole-prompt "
                f"prefills")
        for st in (streams, plain_streams):
            if [len(x) for x in st] != [SERVE["max_new_tokens"]] * 16:
                raise AssertionError(f"{mode}: stream lengths "
                                     f"{[len(x) for x in st]}")
        identical, diverged = 0, []
        for i, (a, b) in enumerate(zip(streams, plain_streams)):
            j = first_divergence(a, b)
            if j is None:
                identical += 1
                continue
            entry = {"request": i, "token": j}
            if mode == "greedy":
                entry["top2_gap"] = top2_gap(model, prompts[i], a[:j])
                if entry["top2_gap"] > 1e-3:
                    raise AssertionError(
                        f"greedy request {i} diverges from the "
                        f"non-speculative engine at token {j} with top-2 "
                        f"logit gap {entry['top2_gap']} > 1e-3")
            diverged.append(entry)
        if not dispatches < ps["decode_steps"]:
            raise AssertionError(
                f"{mode}: {dispatches} verify dispatches, not fewer than "
                f"the non-speculative engine's {ps['decode_steps']} decode "
                f"steps")
        cap, cap_streams, _, _ = run(knobs, SPEC_K, True)
        cap_plain, cap_plain_streams, _, _ = run(knobs, None, True)
        logit_err = 0.0
        for i, (a, b) in enumerate(zip(cap_streams, cap_plain_streams)):
            j = first_divergence(a, b)
            upto = len(a) if j is None else j + 1
            ours = np.stack(cap.captured_logits[i][:upto])
            theirs = np.stack(cap_plain.captured_logits[i][:upto])
            logit_err = max(logit_err, float(np.abs(ours - theirs).max()))
        if logit_err > LOGITS_ATOL:
            raise AssertionError(
                f"{mode}: captured logits differ from the non-speculative "
                f"engine's by {logit_err} > {LOGITS_ATOL} before the first "
                f"divergence")
        drafted = m.spec_draft_tokens.value
        if mode == "greedy":
            report["profile"] = profile_drive(
                run_engine(knobs, SPEC_K), prompts, "verify")
            report["host_ms"] = host_ms(prompts, streams)
        report[mode] = {
            "tokens_out": s["tokens_out"], "wall_s": wall,
            "tokens_per_s": s["tokens_out"] / wall,
            "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
            "tpot_p50_s": s["tpot_p50_s"], "tpot_p99_s": s["tpot_p99_s"],
            "verify_dispatches": dispatches,
            "tokens_per_dispatch": s["tokens_out"] / max(dispatches, 1),
            "whole_prompt_prefills": s["prefills"],
            "chunk_dispatches": m.prefill_chunks.value,
            "goodput_s": s["goodput_s"],
            "verify_ms_mean": s["goodput_s"]["decode"] / dispatches * 1e3,
            "spec_draft_tokens": drafted,
            "spec_accepted_tokens": m.spec_accepted_tokens.value,
            "acceptance": m.spec_accepted_tokens.value / max(drafted, 1),
            "sampled_tokens": m.sampled_tokens.value,
            "launches": launches,
            "streams_identical_to_plain": identical, "diverged": diverged,
            "max_logit_diff_before_divergence": logit_err,
            "plain": {"wall_s": plain_wall,
                      "tokens_per_s": ps["tokens_out"] / plain_wall,
                      "decode_steps": ps["decode_steps"],
                      "decode_ms_mean": ps["goodput_s"]["decode"]
                      / ps["decode_steps"] * 1e3,
                      "goodput_s": ps["goodput_s"],
                      "chunk_dispatches": plain.metrics.prefill_chunks.value,
                      "ttft_p50_s": ps["ttft_p50_s"],
                      "tpot_p50_s": ps["tpot_p50_s"],
                      "tpot_p99_s": ps["tpot_p99_s"],
                      "launches": plain_launches},
        }
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    report["sampler_ms"] = sampler_ms(flush)
    report["sampler_shape"] = {"B": 8, "S": SPEC_K + 1, "V": VOCAB}
    return report


# --------------------------------------------------------------------------- #
# phases 6 and 7: train GPT-base through the facade and the kernels
# --------------------------------------------------------------------------- #


def make_corpus(n=2048, seq_len=128, vocab=64, seed=0):
    """Arithmetic progressions mod vocab (the GPT example's corpus,
    ``examples/gpt_lm/train.py``): the next token follows from the
    previous two, so the loss can fall fast."""
    r = np.random.default_rng(seed)
    start = r.integers(0, vocab, size=(n, 1))
    stride = r.integers(1, 7, size=(n, 1))
    pos = np.arange(seq_len)[None, :]
    return ((start + stride * pos) % vocab).astype(np.int32)


def gpt_base(attention: str, dropout: float = 0.0, layers: int = N_LAYERS,
             chunked_head: bool = False, init_seed: int = SEED,
             device: str = "cuda"):
    """GPT-base on the card from weights seeded by ``init_seed``;
    ``dropout`` on the embeddings and residuals (the flash kernels take no
    dropout of the attention probabilities, so that stays off), the first
    ``layers`` blocks; ``chunked_head`` returns ``(hidden, embedding)``
    for the chunked cross entropy (the same parameters, so the same
    weights)."""
    from stoke_tpu_torch.models.bert import dense_attention
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.ops import make_flash_attention

    flash = attention == "flash"
    model = GPT(vocab_size=VOCAB, size_name="base", max_len=1024,
                dropout_rate=dropout,
                attention_fn=(make_flash_attention(causal=True) if flash
                              else dense_attention),
                attention_is_causal=flash, chunked_head=chunked_head,
                device=device)
    del model.layers[layers:]
    for block in model.layers:
        block.attention.prob_dropout.rate = 0.0
    model.init_weights(init_seed)
    return model


def stoke_for(model, precision, batch, grad_accum=None, loss=None,
              lr=3e-4, seed=0, configs=None, **flags):
    """``Stoke`` over ``model`` with AdamW(``lr``, wd 1e-4) and clip norm
    1.0; ``flags`` are further ``Stoke`` flags (``distributed``, the
    tiers)."""
    from stoke_tpu_torch import ClipGradNormConfig, Stoke, StokeOptimizer
    from stoke_tpu_torch.models.gpt import causal_lm_loss

    return Stoke(model, StokeOptimizer(torch.optim.AdamW, lr=lr,
                                       weight_decay=1e-4),
                 loss or causal_lm_loss, batch_size_per_device=batch,
                 grad_accum=grad_accum, precision=precision,
                 grad_clip=ClipGradNormConfig(max_norm=1.0), seed=seed,
                 configs=configs, **flags)


def profile_step(step) -> dict:
    """Device time of one call of ``step`` (one more training step) by
    CUDA kernel (``torch.profiler``; ops, autograd nodes and annotations
    such as the optimizer step's are left out, since they would count
    their kernels' time again), against its host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((getattr(e, "self_device_time_total", 0.0) / 1e3, e.key, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        reverse=True)
    if not rows:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(r[0] for r in rows)
    attention_ms = sum(r[0] for r in rows if "flash_" in r[1])
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "attention_kernels_ms": attention_ms,
        "attention_kernels": [{"name": n[:90], "calls": c, "ms": ms}
                              for ms, n, c in rows if "flash_" in n],
        "kernels": len(rows), "launches": sum(r[2] for r in rows),
        "top": [{"name": n[:90], "calls": c, "ms": ms}
                for ms, n, c in rows[:12]],
    }


def train(ops) -> dict:
    from stoke_tpu_torch import ArrayDataset

    model = gpt_base("flash")
    stoke = stoke_for(model, "bf16", TRAIN_BATCH)
    corpus = make_corpus(n=96, seq_len=TRAIN_LEN, vocab=VOCAB)
    loader = stoke.DataLoader(ArrayDataset(corpus), shuffle=True,
                              drop_last=True)
    steps = WARMUP_STEPS + TIMED_STEPS
    if len(loader) < steps:
        raise AssertionError(f"{len(loader)} batches for {steps} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times, seen = [], [], []
    for i, batch in enumerate(loader):
        if i == steps:
            break
        seen.append(batch)
        t0 = time.perf_counter()
        losses.append(stoke.train_step(batch, batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    losses = [float(l) for l in losses]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != N_LAYERS * steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in training, "
                f"expected {N_LAYERS} layers x {steps} steps"
            )
    if launches["paged_decode"]:
        raise AssertionError("training launched the decode kernel")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if stoke.optimizer_steps != steps or stoke.backward_steps != steps:
        raise AssertionError(
            f"counters {stoke.optimizer_steps}/{stoke.backward_steps} after "
            f"{steps} train_steps")
    peak = torch.cuda.max_memory_allocated()
    timed = times[WARMUP_STEPS:]
    tokens = TRAIN_BATCH * TRAIN_LEN
    profile = profile_step(lambda: stoke.train_step(corpus[:TRAIN_BATCH],
                                                    corpus[:TRAIN_BATCH]))
    dq_calls = {n: sum(r["calls"] for r in profile.get("attention_kernels", [])
                       if n in r["name"])
                for n in ("flash_bwd_dq_wgmma_kernel",
                          "flash_bwd_dq_tf32x3_kernel")}
    if dq_calls != {"flash_bwd_dq_wgmma_kernel": N_LAYERS,
                    "flash_bwd_dq_tf32x3_kernel": 0}:
        raise AssertionError(f"the profiled bf16 step ran dQ kernels "
                             f"{dq_calls}, expected the bf16 kernel "
                             f"{N_LAYERS} times and the fp32 one never")

    # the four-call loop at grad_accum=2: model -> loss -> backward -> step
    four = stoke_for(model, "bf16", TRAIN_BATCH, grad_accum=2)
    batches = iter(four.DataLoader(ArrayDataset(corpus), shuffle=True,
                                   drop_last=True))
    ops.reset_launches()
    counters = []
    for _ in range(2):
        batch = next(batches)
        loss = four.loss(four.model(batch), batch)
        four.backward(loss)
        four.step()
        counters.append((four.grad_accum_counter, four.backward_steps,
                         four.optimizer_steps))
    torch.cuda.synchronize()
    if counters != [(1, 1, 0), (0, 2, 1)]:
        raise AssertionError(f"four-call counters {counters}, expected "
                             f"[(1, 1, 0), (0, 2, 1)]")
    four_launches = dict(ops.LAUNCHES)
    if any(four_launches[n] != 2 * N_LAYERS
           for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        raise AssertionError(f"four-call launches {four_launches}")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"four-call loss {float(loss)}")
    del four, stoke
    torch.cuda.empty_cache()
    full_head = {"step_ms_p50": float(np.median(timed)) * 1e3,
                 "max_memory_allocated_gib": peak / 2**30,
                 "head_ms": head_ms(seen[0], chunked=False)}
    full_head["head_share_of_kernels"] = (
        full_head["head_ms"] / profile["device_ms"]
        if isinstance(profile.get("device_ms"), float) else "not measured")
    return {
        "phase": "train", "model": "GPT-base (12 x 768, 12 heads, ff 3072, "
        "vocab 50257, max_len 1024), bf16 over fp32 masters, flash "
        "attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "steps": steps, "timed_steps": TIMED_STEPS,
        "step_ms_p50": float(np.median(timed)) * 1e3,
        "step_ms": [t * 1e3 for t in times],
        "tokens_per_s": tokens * len(timed) / sum(timed),
        "max_memory_allocated_gib": peak / 2**30,
        "losses": losses, "launches": launches, "profile": profile,
        "four_call": {"grad_accum": 2, "counters": counters,
                      "launches": four_launches, "loss": float(loss)},
        "full_head": full_head,
        "chunked_head": chunked_head(ops, seen, losses[0]),
    }


# the chunked head against the full one, on the first step's loss: bf16
# rounds each full-head logit to 2^-9 of its size, so a token's cross
# entropy moves by at most 2^-8 max|logit|, and at this init the loss
# (~ln 50257 = 10.8) exceeds max|logit| (~5 at logits of N(0, 1))
CHUNKED_RTOL = 2.0**-8
# the chunked head's bf16 product against the fp32 full-logits cross
# entropy on the same fp32 copies of bf16 values: the forward sums the
# same products in another order (loss to 1e-5 relative); the backward
# rounds the logits' gradient and each product's result to bf16, two
# roundings of at most 2^-8 each, so each gradient's L2 error over its
# L2 norm to 2^-7 (the largest element's error over the largest
# magnitude is printed beside it)
CHUNKED_CARD_LOSS_RTOL = 1e-5
CHUNKED_CARD_GRAD_RTOL = 2.0**-7


def head_inputs(batch):
    """GPT-base's final hidden states of ``batch`` and its embedding from
    the seeded weights, as the bf16 policy hands them to the loss: fp32
    copies of bf16 values."""
    stoke = stoke_for(gpt_base("flash", chunked_head=True), "bf16",
                      TRAIN_BATCH)
    with torch.no_grad():
        h, emb = stoke.model(batch)
    return h, emb


def chunked_card_check(batch) -> dict:
    """The chunked head on the card (bf16 operands under the bf16
    policy's ``compute_dtype``, fp32 logits, the tensor-core backward) on
    one batch's hidden states and embedding, against the fp32 cross
    entropy of the full fp32 logits (TF32 off) on the same tensors: the
    loss, and its gradients of both in L2 norm."""
    from stoke_tpu_torch.models.gpt import causal_lm_loss
    from stoke_tpu_torch.ops import chunked_causal_lm_loss, chunked_ce

    h, emb = head_inputs(batch)
    runs = []
    for chunked in (True, False):
        hh, ee = (h.detach().requires_grad_(), emb.detach().requires_grad_())
        if chunked:
            with chunked_ce.compute_dtype(BF16):
                loss = chunked_causal_lm_loss((hh, ee), batch)
        else:
            loss = causal_lm_loss(hh @ ee.T, batch)
        runs.append((loss.detach(), *torch.autograd.grad(loss, (hh, ee))))
    del h, emb
    (got, *got_g), (want, *want_g) = runs

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    out = {"loss": float(got), "fp32_loss": float(want),
           "loss_rel": rel(got, want), "loss_rtol": CHUNKED_CARD_LOSS_RTOL,
           "grad_hidden_rel": l2(got_g[0], want_g[0]),
           "grad_emb_rel": l2(got_g[1], want_g[1]),
           "grad_rtol": CHUNKED_CARD_GRAD_RTOL,
           "grad_hidden_max_rel": rel(got_g[0], want_g[0]),
           "grad_emb_max_rel": rel(got_g[1], want_g[1])}
    if not (out["loss_rel"] <= CHUNKED_CARD_LOSS_RTOL
            and out["grad_hidden_rel"] <= CHUNKED_CARD_GRAD_RTOL
            and out["grad_emb_rel"] <= CHUNKED_CARD_GRAD_RTOL):
        raise AssertionError(f"chunked head on the card against the fp32 "
                             f"full-logits cross entropy: {out}")
    return out


def head_ms(batch, chunked: bool, iters: int = 5) -> float:
    """Device ms of the LM head alone, forward and backward, on GPT-base's
    final hidden states of ``batch`` (:func:`head_inputs`): the chunked
    cross entropy with bf16 operands (the bf16 policy's
    ``compute_dtype``), or the tied head's bf16 product, its cast to fp32
    and the fp32 cross entropy, as the full-head model computes them."""
    from stoke_tpu_torch.models.gpt import causal_lm_loss
    from stoke_tpu_torch.ops import chunked_causal_lm_loss, chunked_ce

    h, emb = head_inputs(batch)

    def run():
        if chunked:
            hh, ee = (h.detach().requires_grad_(),
                      emb.detach().requires_grad_())
            with chunked_ce.compute_dtype(BF16):
                loss = chunked_causal_lm_loss((hh, ee), batch)
        else:
            hh, ee = (h.to(BF16).requires_grad_(),
                      emb.to(BF16).requires_grad_())
            loss = causal_lm_loss((hh @ ee.T).float(), batch)
        loss.backward()

    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chunked_head(ops, batches, full_first_loss: float) -> dict:
    """GPT-base with ``chunked_head=True`` and the chunked cross entropy
    (bf16 operands under the bf16 policy, fp32 logits, 128-position
    chunks): first :func:`chunked_card_check` on the first batch; then
    over the train phase's batches from the same seeded weights: the
    first step's loss within CHUNKED_RTOL of the full head's, 12 launches
    of each flash kernel a step, the loss falls; step ms p50, peak memory
    and the head's share of the profiled step's kernel time. Then
    ``train_steps`` over the same batches from the same weights: the
    replayed windows give the eager losses bit for bit; their step ms
    p50."""
    from stoke_tpu_torch.ops import chunked_causal_lm_loss

    card_check = chunked_card_check(batches[0])
    torch.cuda.empty_cache()
    stoke = stoke_for(gpt_base("flash", chunked_head=True), "bf16",
                      TRAIN_BATCH, loss=chunked_causal_lm_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, ms = [], []
    for b in batches:
        ms.append(timed_ms(lambda: losses.append(stoke.train_step(b, b))))
    losses = [float(l) for l in losses]
    launches = flash_launches(ops, N_LAYERS * len(batches),
                              "chunked-head train_step")
    peak = torch.cuda.max_memory_allocated()
    rel = abs(losses[0] - full_first_loss) / abs(full_first_loss)
    if not rel <= CHUNKED_RTOL:
        raise AssertionError(f"chunked head: first loss {losses[0]} vs the "
                             f"full head's {full_first_loss}, relative "
                             f"{rel} > {CHUNKED_RTOL}")
    if not (all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"chunked head losses {losses}: not finite "
                             f"or not falling")
    profile = profile_step(lambda: stoke.train_step(batches[0], batches[0]))
    del stoke
    torch.cuda.empty_cache()
    graphed = stoke_for(gpt_base("flash", chunked_head=True), "bf16",
                        TRAIN_BATCH, loss=chunked_causal_lm_loss)
    stacked = torch.stack(batches)
    replayed = graphed.train_steps(stacked, stacked)[:, 0].tolist()
    if replayed != losses:
        raise AssertionError(f"chunked head: replayed windows' losses "
                             f"{replayed} vs eager {losses}")
    replay_ms = [timed_ms(lambda: graphed.train_steps(stacked[i:i + 1],
                                                      stacked[i:i + 1]))
                 for i in range(len(batches))]
    del graphed
    torch.cuda.empty_cache()
    head = head_ms(batches[0], chunked=True)
    return {"loss": "chunked_causal_lm_loss(chunk=128), bf16 operands "
            "under the bf16 policy", "card_check": card_check,
            "losses": losses,
            "first_loss_rel_diff": rel, "rtol": CHUNKED_RTOL,
            "step_ms_p50": float(np.median(ms[WARMUP_STEPS:])),
            "step_ms": ms, "max_memory_allocated_gib": peak / 2**30,
            "replayed_losses_bit_identical": True,
            "replayed_step_ms_p50": float(np.median(
                replay_ms[WARMUP_STEPS:])),
            "launches": launches, "head_ms": head,
            "head_share_of_kernels": (
                head / profile["device_ms"]
                if isinstance(profile.get("device_ms"), float)
                else "not measured"),
            "profile": profile}


def train_parity(ops) -> dict:
    """GPT-base in fp32, B=2, L=512, 3 train_steps through the kernels and
    through dense attention, from the same seeded weights and batches."""
    corpus = make_corpus(n=6, seq_len=512, vocab=VOCAB, seed=1)
    runs, launches = {}, {}
    for attention in ("flash", "dense"):
        stoke = stoke_for(gpt_base(attention), None, 2)
        ops.reset_launches()
        runs[attention] = [
            float(stoke.train_step(corpus[i:i + 2], corpus[i:i + 2]))
            for i in range(0, 6, 2)
        ]
        launches[attention] = dict(ops.LAUNCHES)
        del stoke
        torch.cuda.empty_cache()
    want = 3 * N_LAYERS
    if any(launches["flash"][n] != want for n in
           ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) or any(
               launches["dense"].values()):
        raise AssertionError(f"train parity launches {launches}: the "
                             f"kernel run must launch each flash kernel "
                             f"{want} times, the dense run none")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["flash"],
                                                  runs["dense"]))
    if not rel <= PARITY_RTOL:
        raise AssertionError(
            f"train parity: kernels {runs['flash']} vs dense "
            f"{runs['dense']}, max relative difference {rel} > "
            f"{PARITY_RTOL}")
    return {"phase": "train_parity", "model": "GPT-base, fp32, B=2, L=512",
            "losses_kernels": runs["flash"], "losses_dense": runs["dense"],
            "max_rel_diff": rel, "rtol": PARITY_RTOL, "launches": launches}


# --------------------------------------------------------------------------- #
# phases 8 and 9: the window paths (replayed CUDA graphs) and fp16
# --------------------------------------------------------------------------- #


WINDOW_STEPS = 12
# a window replayed from its CUDA graph runs the eager step's kernels in
# the eager step's order, so their losses should agree to the last bit
WINDOW_RTOL = 1e-6
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def window_batches(n: int) -> torch.Tensor:
    """``n`` training batches of the example corpus, ``[n, B, L]`` int32 on
    the card."""
    corpus = make_corpus(n=n * TRAIN_BATCH, seq_len=TRAIN_LEN, vocab=VOCAB,
                         seed=2)
    return torch.from_numpy(corpus).view(n, TRAIN_BATCH, TRAIN_LEN).cuda()


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def timed_ms(fn) -> float:
    """Host ms of ``fn()`` up to a synchronize of the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def flash_launches(ops, want: int, what: str) -> dict:
    """The flash kernels' launch counts, each of which must be ``want``."""
    got = {n: ops.LAUNCHES[n] for n in FLASH}
    if any(c != want for c in got.values()):
        raise AssertionError(f"{what}: flash launches {got}, expected "
                             f"{want} of each")
    return got


def eager_steps(stoke, batches) -> tuple:
    """One ``train_step`` a batch, each timed; returns (losses, ms)."""
    losses, ms = [], []
    for b in batches:
        ms.append(timed_ms(lambda: losses.append(stoke.train_step(b, b))))
    return [float(l) for l in losses], ms


def step_summary(ms, profile) -> dict:
    """Step ms p50 over all but the first two steps, with the profile's
    busy share."""
    return {"step_ms_p50": float(np.median(ms[WARMUP_STEPS:])),
            "step_ms": ms,
            "device_busy_share": profile.get("device_busy_share",
                                             "not measured"),
            "profile": profile}


def dropout_windows(ops) -> dict:
    """GPT-base cut to 2 blocks, dropout 0.1 on the embeddings and
    residuals drawn from ``Stoke(seed=...)``'s generator, which a captured
    window registers. Reports whether replays draw the eager steps' masks
    (the same seed, eager ``train_step`` against ``train_steps``); holds
    that replays draw fresh masks (lr 0, one batch four times: four
    different losses) and that the graphed loss falls."""
    batches = window_batches(WINDOW_STEPS)
    eager = stoke_for(gpt_base("flash", 0.1, 2), "bf16", TRAIN_BATCH, seed=5)
    eager_losses, _ = eager_steps(eager, batches[:4])
    del eager
    graphed = stoke_for(gpt_base("flash", 0.1, 2), "bf16", TRAIN_BATCH,
                        seed=5)
    losses = graphed.train_steps(batches, batches)[:, 0].tolist()
    del graphed
    still = stoke_for(gpt_base("flash", 0.1, 2), "bf16", TRAIN_BATCH,
                      lr=0.0, seed=5)
    same = batches[:1].expand(4, -1, -1)
    fixed = still.train_steps(same, same)[:, 0].tolist()
    del still
    torch.cuda.empty_cache()
    if len(set(fixed)) != len(fixed):
        raise AssertionError(f"dropout under replay: one batch at lr 0 gave "
                             f"{fixed}; the masks did not change")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"dropout under replay: the loss did not fall: "
                             f"{losses}")
    return {"layers": 2, "dropout": 0.1, "eager_losses": eager_losses,
            "graphed_losses": losses,
            "replay_masks_equal_eager": losses[:4] == eager_losses,
            "max_rel_diff_vs_eager": rel_diff(losses[:4], eager_losses),
            "lr0_losses": fixed}


def train_window(ops) -> dict:
    """``train_steps`` and ``train_step_window`` on GPT-base in bf16 with
    flash attention, AdamW(3e-4, wd 1e-4), clip norm 1.0, B=8, L=1024,
    dropout 0: 12 eager ``train_step``s against ``train_steps`` over the
    same 12 batches (one window eagerly, its capture, 11 replays), and
    with ``segment_size=4``; ``train_step_window`` at ``grad_accum=2``
    against the four-call loop. Losses agree to WINDOW_RTOL, counters
    match, and the flash kernels read 12 launches a layer a step through
    the replays. Times replayed windows (one ``train_steps`` call a
    window) beside the eager steps, with one profiled each."""
    n = WINDOW_STEPS
    batches = window_batches(n)
    a = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH)
    ops.reset_launches()
    eager, eager_ms = eager_steps(a, batches)
    flash_launches(ops, N_LAYERS * n, "eager train_step")
    eager_profile = profile_step(lambda: a.train_step(batches[0],
                                                      batches[0]))
    del a
    torch.cuda.empty_cache()

    b = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH)
    ops.reset_launches()
    out = {}
    first_ms = timed_ms(lambda: out.update(r=b.train_steps(batches,
                                                           batches)))
    launches = flash_launches(ops, N_LAYERS * n, "train_steps")
    graphed = out["r"][:, 0].tolist()
    if (b.optimizer_steps, b.backward_steps) != (n, n):
        raise AssertionError(f"train_steps counters {b.optimizer_steps}/"
                             f"{b.backward_steps}, expected {n}/{n}")
    diff = rel_diff(graphed, eager)
    if not diff <= WINDOW_RTOL:
        raise AssertionError(f"train_steps losses {graphed} vs eager "
                             f"{eager}: max relative difference {diff}")
    replay_ms = [timed_ms(lambda: b.train_steps(batches[i:i + 1],
                                                batches[i:i + 1]))
                 for i in range(WARMUP_STEPS + TIMED_STEPS)]
    replay_profile = profile_step(lambda: b.train_steps(batches[:1],
                                                        batches[:1]))
    del b, out
    torch.cuda.empty_cache()

    c = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH)
    segmented = c.train_steps(batches, batches, segment_size=4)[:, 0].tolist()
    seg_diff = rel_diff(segmented, eager)
    if c.optimizer_steps != n or not seg_diff <= WINDOW_RTOL:
        raise AssertionError(f"segment_size=4: {c.optimizer_steps} steps, "
                             f"losses {segmented} vs eager {eager}")
    del c
    torch.cuda.empty_cache()

    four = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, grad_accum=2)
    four_losses = []
    for i in range(4):
        loss = four.loss(four.model(batches[i]), batches[i])
        four.backward(loss)
        four.step()
        four_losses.append(float(loss))
    del four
    win = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, grad_accum=2)
    ops.reset_launches()
    win_losses = []
    for w in range(2):
        win_losses += win.train_step_window(batches[2 * w:2 * w + 2],
                                            batches[2 * w:2 * w + 2]).tolist()
    accum_launches = flash_launches(ops, 4 * N_LAYERS,
                                    "train_step_window at grad_accum=2")
    counters = (win.grad_accum_counter, win.backward_steps,
                win.optimizer_steps)
    accum_diff = rel_diff(win_losses, four_losses)
    if counters != (0, 4, 2) or not accum_diff <= WINDOW_RTOL:
        raise AssertionError(f"train_step_window at grad_accum=2: counters "
                             f"{counters}, losses {win_losses} vs four-call "
                             f"{four_losses}")
    del win
    torch.cuda.empty_cache()
    return {
        "phase": "train_window", "model": "GPT-base, bf16 over fp32 "
        "masters, flash attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "steps": n,
        "eager": step_summary(eager_ms, eager_profile),
        "replayed": step_summary(replay_ms, replay_profile),
        "train_steps_first_call_ms": first_ms,
        "losses_eager": eager, "losses_train_steps": graphed,
        "max_rel_diff": diff, "rtol": WINDOW_RTOL,
        "losses_segment_size_4": segmented, "segment_max_rel_diff": seg_diff,
        "launches": launches,
        "grad_accum_2": {"losses_window": win_losses,
                         "losses_four_call": four_losses,
                         "max_rel_diff": accum_diff, "counters": counters,
                         "launches": accum_launches},
        "dropout": dropout_windows(ops),
    }


# --------------------------------------------------------------------------- #
# phase 18: telemetry, tracing and the health monitor on the training path
# --------------------------------------------------------------------------- #

TELEMETRY_EAGER = WARMUP_STEPS + TIMED_STEPS   # timed eager train_steps
TELEMETRY_WINDOWS = 4                          # windows of the first call
TELEMETRY_REPLAYS = WARMUP_STEPS + TIMED_STEPS  # timed replays, one a call
TELEMETRY_FOUR_CALL = 2                        # four-call steps at the end
GRAD_NORM_RTOL = 1e-5
NAN_STEP = 3
BUNDLE_FILES = ("manifest.json", "ring.jsonl", "config.json", "mesh.json",
                "environment.json", "registry.json", "trace.json",
                "stacks.txt")


def telemetry_configs(root: str, tag: str):
    """``TelemetryConfig(log_every_n_steps=1)``, ``TraceConfig``,
    ``HealthConfig(sentinels=True, watchdog=True)`` and a
    ``ProfilerConfig`` under ``root/tag``."""
    from stoke_tpu_torch import (HealthConfig, ProfilerConfig,
                                 TelemetryConfig, TraceConfig)

    out = os.path.join(root, tag)
    return [TelemetryConfig(output_dir=os.path.join(out, "telemetry"),
                            log_every_n_steps=1, grad_norm=True),
            TraceConfig(output_dir=os.path.join(out, "trace")),
            HealthConfig(sentinels=True, watchdog=True),
            ProfilerConfig(trace_dir=os.path.join(out, "profile"))]


def host_param_norms(stoke, before) -> tuple:
    """The parameters' global 2-norm and the update ratio
    ``||new - old|| / (||new|| + 1e-12)`` after a step, ``before`` the
    parameters' copies taken before it, in fp64 on the card."""
    p2 = u2 = 0.0
    for p, b in zip(stoke.model_access.parameters(), before):
        new = p.detach().double()
        p2 += float((new * new).sum())
        u2 += float(((new - b.double()) ** 2).sum())
    return float(np.sqrt(p2)), float(np.sqrt(u2) / (np.sqrt(p2) + 1e-12))


def nonfinite_flags_on_card() -> dict:
    """The sentinels' per-leaf non-finite flags on CUDA tensors against
    ``any(~isfinite(leaf))``: a NaN, an inf and a -inf, a finite leaf whose
    squares overflow fp32, bf16 and fp16 leaves, and leaves of the tied
    embedding's size (50257 x 768) finite and with a NaN at their end."""
    from stoke_tpu_torch.telemetry.health import nonfinite_flags

    gen = torch.Generator(device="cuda").manual_seed(0)

    def leaf(n, dtype=torch.float32, at=None, value=None):
        t = torch.randn(n, generator=gen, device="cuda").to(dtype)
        if at is not None:
            t[at] = value
        return t

    big = VOCAB * HEADS * HEAD_DIM
    leaves = {
        "finite": leaf(4096), "nan": leaf(4096, at=17, value=float("nan")),
        "inf": leaf(4096, at=4095, value=float("inf")),
        "neg_inf": leaf(4096, at=0, value=float("-inf")),
        "huge_finite": torch.full((4096,), 3e38, device="cuda"),
        "bf16_inf": leaf(4096, torch.bfloat16, at=3, value=float("inf")),
        "fp16_nan": leaf(4096, torch.float16, at=9, value=float("nan")),
        "big_finite": leaf(big),
        "big_nan": leaf(big, at=big - 1, value=float("nan")),
    }
    got = nonfinite_flags(list(leaves.values())).tolist()
    want = [float((~torch.isfinite(t)).any()) for t in leaves.values()]
    if got != want:
        raise AssertionError(f"train_telemetry: non-finite flags {got} on "
                             f"the card, expected {want} for "
                             f"{list(leaves)}")
    return dict(zip(leaves, got))


def host_grad_norm(stoke) -> float:
    """The accumulated gradients' global 2-norm, recomputed on the host in
    fp64."""
    total = 0.0
    for p in stoke.model_access.parameters():
        if p.grad is not None:
            g = p.grad.detach().to("cpu", torch.float64)
            total += float((g * g).sum())
    return float(np.sqrt(total))


def telemetry_run(ops, batches, configs) -> dict:
    """GPT-base bf16 under ``configs`` (None: no config): eager
    ``train_step``s (timed), one profiled; ``train_steps`` over
    TELEMETRY_WINDOWS windows (the capture), timed one-window replays, one
    profiled; then TELEMETRY_FOUR_CALL four-call steps, with sentinels
    each gradient's norm recomputed on the host before its ``step`` and
    the parameters' norm and update ratio after it. Returns the run's
    numbers with its Stoke."""
    s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, configs=configs)
    e, w, r = TELEMETRY_EAGER, TELEMETRY_WINDOWS, TELEMETRY_REPLAYS
    ops.reset_launches()
    losses, eager_ms = eager_steps(s, batches[:e])
    eager_prof = profile_step(lambda: s.train_step(batches[e], batches[e]))
    eager_launches = {n: ops.LAUNCHES[n] for n in FLASH}
    ops.reset_launches()
    first = s.train_steps(batches[:w], batches[:w])[:, 0].tolist()
    replay_ms, replayed = [], []
    for i in range(r):
        b = batches[w + i:w + i + 1]
        replay_ms.append(timed_ms(
            lambda: replayed.append(float(s.train_steps(b, b)[0, 0]))))
    replay_prof = profile_step(lambda: s.train_steps(batches[:1],
                                                     batches[:1]))
    replay_launches = {n: ops.LAUNCHES[n] for n in FLASH}
    four, norms, rows = [], [], []
    for i in range(TELEMETRY_FOUR_CALL):
        b = batches[i]
        loss = s.loss(s.model(b), b)
        s.backward(loss)
        before = ([p.detach().clone() for p in s.model_access.parameters()]
                  if s.health is not None else None)
        grad_norm = host_grad_norm(s)
        s.step()
        four.append(float(loss))
        if s.health is not None:
            norms.append((grad_norm, *host_param_norms(s, before)))
            rows.append(s._last_sentinels.tolist())
        del before
    return {
        "stoke": s, "losses": losses + first + replayed + four,
        "eager": step_summary(eager_ms, eager_prof),
        "replayed": step_summary(replay_ms, replay_prof),
        "launches": {"eager": eager_launches, "replayed": replay_launches},
        "dispatch_count": s.dispatch_count,
        "host_grad_norms": norms, "four_call_sentinels": rows,
    }


def trace_counts(path: str) -> dict:
    """Duration events of an exported trace, by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts: dict = {}
    for ev in events:
        if ev.get("ph") == "X":
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


def telemetry_files(s, steps: int) -> dict:
    """Read back the "on" run's files: ``steps.jsonl`` line by line
    through the port's validator (the windows' steps summed), the
    Prometheus file, the exported trace's step spans, the sentinel rows
    in the flight recorder's ring (one a step, steps 1..n)."""
    from stoke_tpu_torch.telemetry.events import read_step_events

    tcfg = s.status.telemetry_config
    records = read_step_events(os.path.join(tcfg.output_dir, "steps.jsonl"))
    if sum(r["window_steps"] for r in records) != steps or not all(
            r["param_norm"] is not None for r in records):
        raise AssertionError(f"train_telemetry: {len(records)} step events "
                             f"cover {[r['window_steps'] for r in records]}"
                             f" steps, expected {steps}")
    prom = os.path.join(tcfg.output_dir, "metrics.prom")
    if not os.path.getsize(prom):
        raise AssertionError("train_telemetry: metrics.prom is empty")
    counts = trace_counts(s.export_trace())
    sentinel_steps = [e["step"] for e in s.health.recorder.ring
                      if e["kind"] == "sentinels"]
    if sentinel_steps != list(range(1, steps + 1)):
        raise AssertionError(f"train_telemetry: sentinel rows for steps "
                             f"{sentinel_steps}, expected 1..{steps}")
    return {"step_events": len(records), "metrics_prom_bytes":
            os.path.getsize(prom), "trace_span_counts": counts,
            "sentinel_rows": len(sentinel_steps),
            "last_event": {k: records[-1][k] for k in (
                "step", "window_steps", "host_dispatch_s", "device_step_s",
                "grad_norm", "param_norm", "update_ratio",
                "nonfinite_leaves", "compiles_total", "recompiles",
                "compile_time_s", "hbm_peak_bytes")}}


def nan_at_step(ops, root: str) -> dict:
    """A fresh GPT-base, eagerly: a one-shot gradient hook makes one named
    parameter's gradient NaN at step NAN_STEP. The non-finite detector
    must fire at that step naming the parameter's JAX leaf path, and its
    bundle must hold BUNDLE_FILES."""
    from stoke_tpu_torch.convert import jax_param_layout

    model = gpt_base("flash")
    names = [n for n, _ in model.named_parameters()]
    name = names[len(names) // 2]
    want = "/".join(jax_param_layout(model)[name][0])
    s = stoke_for(model, "bf16", TRAIN_BATCH,
                  configs=telemetry_configs(root, "nan")[:3])
    calls = []

    def poison(g):
        calls.append(1)
        return g * float("nan") if len(calls) == NAN_STEP else g

    dict(model.named_parameters())[name].register_hook(poison)
    batches = window_batches(NAN_STEP + 1)
    for b in batches:
        s.train_step(b, b)
    fired = [a for a in s.health.anomalies if a.detector == "nonfinite_grads"]
    s.close_telemetry()
    if not fired or fired[0].step != NAN_STEP:
        raise AssertionError(f"train_telemetry: NaN at step {NAN_STEP}, "
                             f"detector fired at "
                             f"{[a.step for a in fired]}")
    got = (fired[0].context or {}).get("first_leaf_path")
    if got != want or fired[0].value != 1.0:
        raise AssertionError(f"train_telemetry: the detector named {got} "
                             f"({fired[0].value} leaves), expected {want}")
    bundle = s.health.recorder.dumps[0]
    files = sorted(os.listdir(bundle))
    if set(BUNDLE_FILES) - set(files):
        raise AssertionError(f"train_telemetry: bundle {files} lacks "
                             f"{set(BUNDLE_FILES) - set(files)}")
    del s, model
    return {"step": fired[0].step, "parameter": name, "leaf_path": got,
            "message": fired[0].message, "bundle_files": files,
            "launches": {n: ops.LAUNCHES[n] for n in FLASH}}


def profiled_trace(s) -> dict:
    """One ``train_step`` under ``Stoke.profile_trace`` into
    ``ProfilerConfig.trace_dir``: the trace file must name the three flash
    kernels."""
    b = window_batches(1)[0]
    with s.profile_trace("gpt_base"):
        s.train_step(b, b)
    path = os.path.join(s.profiler_config.trace_dir,
                        "gpt_base.rank0.pt.trace.json")
    with open(path) as f:
        text = f.read()
    found = {k: text.count(k) for k in WGMMA_KERNELS}
    if not all(found.values()):
        raise AssertionError(f"train_telemetry: the profile_trace file names "
                             f"the flash kernels {found}")
    return {"file_bytes": len(text), "kernel_events": found}


def traced_serve(ops) -> dict:
    """GPT-base serving (the ``serve`` phase's settings and prompts), one
    drive untraced and one with a trace recorder registered: span counts
    by name and each request's timeline (admission, prefill, decode
    slices, eviction), TPOT p50 of each drive, and the flash prefill and
    paged decode kernels' launches in the traced drive."""
    from stoke_tpu_torch.configs import ServeConfig, TraceConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine
    from stoke_tpu_torch.telemetry.tracing import (TraceRecorder,
                                                   register_recorder,
                                                   unregister_recorder)

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = model.state_dict()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, model.vocab_size, size=int(n)) for n in lens]
    cfg = ServeConfig(attention="flash", decode_kernel="pallas", **SERVE)
    ServingEngine(model, weights, cfg).generate([prompts[0][:16]], 2)
    plain = ServingEngine(model, weights, cfg)
    plain_streams, plain_wall = drive(plain, prompts)
    rec = TraceRecorder(TraceConfig(ring_size=1 << 16))
    register_recorder(rec)
    try:
        engine = ServingEngine(model, weights, cfg)
        ops.reset_launches()
        streams, wall = drive(engine, prompts)
        launches = {n: ops.LAUNCHES[n] for n in ("flash_fwd", "paged_decode")}
    finally:
        unregister_recorder(rec)
    summary, base = engine.summary(), plain.summary()
    by_name: dict = {}
    per_request: dict = {}
    for sp in rec.spans():
        by_name[sp.name] = by_name.get(sp.name, 0) + 1
        if sp.request_id is not None:
            row = per_request.setdefault(sp.request_id, {})
            row[sp.name] = row.get(sp.name, 0) + 1
    for rid, row in per_request.items():
        if (row.get("serve/admission"), row.get("serve/prefill"),
                row.get("serve/evict")) != (1, 1, 1) or not row.get(
                    "serve/decode"):
            raise AssertionError(f"traced serve: request {rid}'s spans "
                                 f"{row}")
    if len(per_request) != 16 or streams != plain_streams:
        raise AssertionError("traced serve: the traced drive's requests or "
                             "streams differ from the untraced drive's")
    if launches["flash_fwd"] != N_LAYERS * summary["prefills"] or launches[
            "paged_decode"] != N_LAYERS * summary["decode_steps"]:
        raise AssertionError(f"traced serve: launches {launches}")
    del engine, plain, model
    return {"requests": 16, "span_counts": by_name,
            "spans_per_request": per_request[min(per_request)],
            "dropped": rec.dropped, "launches": launches,
            "tpot_p50_s": summary["tpot_p50_s"],
            "tpot_p50_s_untraced": base["tpot_p50_s"],
            "tokens_per_s": summary["tokens_out"] / wall,
            "tokens_per_s_untraced": base["tokens_out"] / plain_wall}


def train_telemetry(ops) -> dict:
    """GPT-base bf16 at full width with and without TelemetryConfig
    (every step logged), TraceConfig, HealthConfig (sentinels and the
    watchdog) and ProfilerConfig, over the same batches: the flash
    kernels' launches, ``dispatch_count``, the losses and the final
    parameters equal bit for bit; step ms p50 eager and replayed with the
    profiled busy share and kernel launches of each; the files read back;
    the sentinel rows' norms against the host's (rel GRAD_NORM_RTOL) and
    the non-finite flags on the card against ``any(~isfinite)``; then a
    NaN at a known step, ``profile_trace``, and the traced serve drive."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke_telemetry_")
    try:
        flags = nonfinite_flags_on_card()
        n = (TELEMETRY_EAGER + 1 + TELEMETRY_WINDOWS + TELEMETRY_REPLAYS
             + 1 + TELEMETRY_FOUR_CALL)
        batches = window_batches(TELEMETRY_WINDOWS + TELEMETRY_REPLAYS + 1)
        off = telemetry_run(ops, batches, None)
        off_params = [p.detach().clone() for p in
                      off["stoke"].model_access.parameters()]
        del off["stoke"]
        torch.cuda.empty_cache()
        on = telemetry_run(ops, batches, telemetry_configs(root, "on"))
        s = on.pop("stoke")
        if on["launches"] != off["launches"]:
            raise AssertionError(f"train_telemetry: flash launches "
                                 f"{on['launches']} with the configs, "
                                 f"{off['launches']} without")
        if on["dispatch_count"] != off["dispatch_count"]:
            raise AssertionError(f"train_telemetry: dispatch_count "
                                 f"{on['dispatch_count']} vs "
                                 f"{off['dispatch_count']}")
        if on["losses"] != off["losses"]:
            raise AssertionError(f"train_telemetry: losses differ: "
                                 f"{on['losses']} vs {off['losses']}")
        same = all(torch.equal(a, b) for a, b in zip(
            s.model_access.parameters(), off_params))
        if not same:
            raise AssertionError("train_telemetry: the final parameters "
                                 "differ with the configs on")
        del off_params
        # grad norm, param norm, update ratio against the host's; the
        # non-finite count, skip flag and first bad leaf exact
        grad_rel = [abs(row[i + 1] - h[i]) / h[i] for row, h in
                    zip(on["four_call_sentinels"], on["host_grad_norms"])
                    for i in range(3)]
        if not max(grad_rel) <= GRAD_NORM_RTOL or any(
                row[4:6] + row[7:] != [0.0, 0.0, -1.0]
                for row in on["four_call_sentinels"]):
            raise AssertionError(f"train_telemetry: sentinel rows "
                                 f"{on['four_call_sentinels']} vs host "
                                 f"{on['host_grad_norms']}")
        files = telemetry_files(s, n)
        counts = {k: v["count"]
                  for k, v in s.trace_summary["by_name"].items()}
        dispatches = n - TELEMETRY_FOUR_CALL
        got = (counts["stoke/dispatch"], counts["stoke/step [step]"],
               counts["stoke/accum"])
        if got != (dispatches, TELEMETRY_FOUR_CALL, TELEMETRY_FOUR_CALL):
            raise AssertionError(f"train_telemetry: step spans {counts}, "
                                 f"expected {dispatches} dispatches")
        profiled = profiled_trace(s)
        health = {"anomalies": s.health.anomaly_count,
                  "by_detector": s.health.anomaly_counts_by_detector(),
                  "watchdog_trips": s.health.watchdog.trips}
        s.close_telemetry()
        launches = {k: on["launches"]["eager"][k]
                    + on["launches"]["replayed"][k] for k in FLASH}
        del s
        torch.cuda.empty_cache()
        ops.reset_launches()
        nan = nan_at_step(ops, root)
        torch.cuda.empty_cache()
        served = traced_serve(ops)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # kernels the profiled step launched, with and without the configs
    added = {k: {c: r[k]["profile"].get("launches", "not measured")
                 for c, r in (("off", off), ("on", on))}
             for k in ("eager", "replayed")}
    return {
        "phase": "train_telemetry", "model": "GPT-base, bf16 over fp32 "
        "masters, flash attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "steps": n,
        "configs": "TelemetryConfig(log_every_n_steps=1, grad_norm=True), "
        "TraceConfig, HealthConfig(sentinels=True, watchdog=True), "
        "ProfilerConfig(trace_dir)",
        "off": {k: off[k] for k in ("eager", "replayed", "dispatch_count")},
        "on": {k: on[k] for k in ("eager", "replayed", "dispatch_count")},
        "step_ms_p50": {"eager_off": off["eager"]["step_ms_p50"],
                        "eager_on": on["eager"]["step_ms_p50"],
                        "replayed_off": off["replayed"]["step_ms_p50"],
                        "replayed_on": on["replayed"]["step_ms_p50"]},
        "profiled_kernel_launches": added,
        "launches": launches, "launches_by_path": on["launches"],
        "losses_bit_equal": True, "params_bit_equal": True,
        "sentinels_vs_host": {"fields": ["grad_norm", "param_norm",
                                         "update_ratio"],
                              "sentinel": [r[1:4] for r in
                                           on["four_call_sentinels"]],
                              "host_fp64": on["host_grad_norms"],
                              "max_rel": max(grad_rel),
                              "rtol": GRAD_NORM_RTOL},
        "nonfinite_flags": flags,
        "files": files, "health": health, "profile_trace": profiled,
        "nan": nan, "serve_traced": served,
        "phase_s": time.perf_counter() - t0,
    }


def max_ds_in_step(step) -> float:
    """The largest |dS| that the flash backward meets in ``step()``, the
    loss scale included: each backward's inputs go through
    ``max_abs_ds`` before the kernels run."""
    fa = importlib.import_module("stoke_tpu_torch.ops.flash_attention")
    seen = []
    kernels = fa._flash_backward

    def probe(ctx, do, dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        seen.append(max_abs_ds(q, k, v, mask, out, lse, do, ctx.causal))
        return kernels(ctx, do, dlse)

    fa._flash_backward = probe
    try:
        step()
    finally:
        fa._flash_backward = kernels
    return max(seen)


def overflow_window(stoke, run, boom) -> dict:
    """``run()`` one window with the loss times ``boom`` = inf: the
    parameters and every optimizer state tensor must stay bit for bit, the
    scale halve and ``skipped_optimizer_steps`` grow by 1."""
    params = list(stoke.model_access.parameters())
    before = [p.detach().clone() for p in params]
    state = [{k: v.clone() for k, v in stoke.optimizer.state[p].items()}
             for p in params]
    scale, skipped = stoke.loss_scale, stoke.skipped_optimizer_steps
    boom.fill_(float("inf"))
    run()
    boom.fill_(1.0)
    torch.cuda.synchronize()
    same = all(torch.equal(a, p) for a, p in zip(before, params)) and all(
        torch.equal(v, stoke.optimizer.state[p][k])
        for s, p in zip(state, params) for k, v in s.items())
    out = {"bit_identical": same, "scale_before": scale,
           "scale_after": stoke.loss_scale, "skipped_before": skipped,
           "skipped_after": stoke.skipped_optimizer_steps,
           "state_tensors": sum(len(s) for s in state) + len(params)}
    if (not same or out["scale_after"] != scale / 2
            or out["skipped_after"] != skipped + 1):
        raise AssertionError(f"overflow window: {out}")
    return out


def train_fp16(ops) -> dict:
    """GPT-base in fp16 over fp32 masters with the dynamic loss scaler,
    flash attention through the fp16 ``wgmma`` kernels, B=8, L=1024: 12
    eager ``train_step``s, then ``train_steps`` over the same 12 batches
    from the same seed (losses agree to WINDOW_RTOL, the loss falls). The
    profiled step must run the fp16 forward, dQ and dK/dV kernels 12 times
    each and the bf16 and fp32 ones never. Then one window whose loss is
    multiplied by inf, eagerly and replayed (``overflow_window``)."""
    from stoke_tpu_torch.models.gpt import causal_lm_loss

    boom = torch.ones((), device="cuda")

    def loss(logits, ids):
        return causal_lm_loss(logits, ids) * boom

    n = WINDOW_STEPS
    batches = window_batches(n)
    a = stoke_for(gpt_base("flash"), "fp16", TRAIN_BATCH, loss=loss)
    ops.reset_launches()
    eager, eager_ms = eager_steps(a, batches)
    launches = flash_launches(ops, N_LAYERS * n, "fp16 train_step")
    if not (all(np.isfinite(eager)) and np.mean(eager[-3:]) < eager[0]):
        raise AssertionError(f"fp16 losses {eager}: not finite or not "
                             f"falling")
    profile = profile_step(lambda: a.train_step(batches[0], batches[0]))
    names = {"fp16": "<__half", "bf16": "<__nv_bfloat16", "fp32": "tf32x3"}
    calls = {f"{kernel} {t}": sum(r["calls"] for r in
                                  profile.get("attention_kernels", [])
                                  if kernel in r["name"] and tag in r["name"])
             for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
             for t, tag in names.items()}
    if any(c != (N_LAYERS if t.endswith("fp16") else 0)
           for t, c in calls.items()):
        raise AssertionError(f"the profiled fp16 step ran {calls}, expected "
                             f"each fp16 kernel {N_LAYERS} times and no "
                             f"other")
    eager_state = {"loss_scale": a.loss_scale,
                   "skipped_optimizer_steps": a.skipped_optimizer_steps}
    ds = max_ds_in_step(lambda: a.train_step(batches[1], batches[1]))
    scale_ds = a.loss_scale
    eager_skip = overflow_window(
        a, lambda: a.train_step(batches[2], batches[2]), boom)
    del a
    torch.cuda.empty_cache()

    b = stoke_for(gpt_base("flash"), "fp16", TRAIN_BATCH, loss=loss)
    graphed = b.train_steps(batches, batches)[:, 0].tolist()
    diff = rel_diff(graphed, eager)
    if not diff <= WINDOW_RTOL:
        raise AssertionError(f"fp16 train_steps losses {graphed} vs eager "
                             f"{eager}: max relative difference {diff}")
    graph_state = {"loss_scale": b.loss_scale,
                   "skipped_optimizer_steps": b.skipped_optimizer_steps}
    replay_ms = [timed_ms(lambda: b.train_steps(batches[i:i + 1],
                                                batches[i:i + 1]))
                 for i in range(WARMUP_STEPS + TIMED_STEPS)]
    replay_skip = overflow_window(
        b, lambda: b.train_steps(batches[2:3], batches[2:3]), boom)
    del b
    torch.cuda.empty_cache()
    return {
        "phase": "train_fp16", "model": "GPT-base, fp16 over fp32 masters, "
        "dynamic loss scale from 2^16, flash attention, AdamW(lr 3e-4, wd "
        "1e-4), clip norm 1.0", "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "steps": n, "losses_eager": eager, "losses_train_steps": graphed,
        "max_rel_diff": diff, "rtol": WINDOW_RTOL,
        "eager_step_ms": eager_ms,
        "step_ms_p50": float(np.median(eager_ms[WARMUP_STEPS:])),
        "replayed_step_ms": replay_ms,
        "replayed_step_ms_p50": float(np.median(replay_ms[WARMUP_STEPS:])),
        "after_12_steps": {"eager": eager_state, "train_steps": graph_state},
        "max_abs_ds": ds, "max_abs_ds_loss_scale": scale_ds,
        "launches": launches, "kernel_calls": calls, "profile": profile,
        "overflow_eager": eager_skip, "overflow_replayed": replay_skip,
    }


# --------------------------------------------------------------------------- #
# phase 10: checkpoints, resume and serve() through the facade
# --------------------------------------------------------------------------- #


#: micro-batches of the checkpoint phase: 4 steps of 2, one more, the 5
#: that finish the saver's window and make 2 more steps, and one window
#: after the load under a captured window
CKPT_MICRO = 16
#: the fp16 run's depth (resume and the scaler state, not speed)
CKPT_FP16_LAYERS = 2


def tag_bytes(tag_dir: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(tag_dir, f))
               for f in os.listdir(tag_dir))


def masters_equal(a, b) -> bool:
    """Whether two runs' fp32 master parameters are bit for bit equal."""
    return all(torch.equal(p, q) for p, q in
               zip(a.model_access.parameters(), b.model_access.parameters()))


def fp16_resume(ops, root: str, batches) -> dict:
    """Steps 1-2 of :func:`checkpoint` in fp16 at CKPT_FP16_LAYERS blocks:
    two replayed steps, a micro-batch, an async save mid-window, 5 more
    micro-batches; a run of another seed loads the tag and must repeat
    them bit for bit, its loss scale and growth count equal to the
    saver's at the save."""
    import os

    from stoke_tpu_torch.configs import CheckpointConfig

    a = stoke_for(gpt_base("flash", layers=CKPT_FP16_LAYERS), "fp16",
                  TRAIN_BATCH, grad_accum=2,
                  configs=[CheckpointConfig(async_save=True)])
    a.train_steps(batches[:4], batches[:4])
    a.train_step(batches[4], batches[4])
    at_save = {k: v.clone() for k, v in a.scaler.items()}
    tag = a.save(root, name="fp16")
    saver, _ = eager_steps(a, batches[5:10])
    a.wait_for_checkpoint()
    b = stoke_for(gpt_base("flash", layers=CKPT_FP16_LAYERS,
                           init_seed=SEED + 1), "fp16", TRAIN_BATCH,
                  grad_accum=2, seed=1)
    b.load(root, tag=os.path.basename(tag))
    scaler_equal = all(torch.equal(b.scaler[k], v) for k, v in at_save.items())
    loaded = {k: v.tolist() for k, v in b.scaler.items()}
    resumed, _ = eager_steps(b, batches[5:10])
    out = {"layers": CKPT_FP16_LAYERS, "losses_saver": saver,
           "losses_resumed": resumed,
           "scaler_at_save": {k: v.tolist() for k, v in at_save.items()},
           "scaler_after_load": loaded, "scaler_equal": scaler_equal,
           "masters_equal": masters_equal(a, b)}
    if not (scaler_equal and resumed == saver and out["masters_equal"]):
        raise AssertionError(f"fp16 resume: {out}")
    return out


def checkpoint(ops) -> dict:
    """Checkpoints through the facade at GPT-base width (bf16 over fp32
    masters, flash attention, AdamW, B=8, L=1024), in a temporary
    directory removed at the end:

    1. run A (``grad_accum=2``, ``CheckpointConfig(save_every_n_steps=2,
       max_to_keep=2, async_save=True)``): 4 steps, one ``train_steps``
       call each (eager window, capture, replays), auto-saved at steps 2
       and 4; a micro-batch; an explicit save with the window half full;
       5 more micro-batches (steps 5-7; step 6 auto-saves);
    2. run B (other weights, another seed) loads the mid-window tag and
       repeats the 5 micro-batches: losses and masters bit for bit;
    3. run A loads the step-4 tag under its captured window and replays
       one window; run C, fresh, resumes the newest tag
       (``maybe_resume``: step 6), loads the step-4 tag and runs the same
       window: bit for bit;
    4. fp16 at 2 blocks (:func:`fp16_resume`);
    5. 2 auto tags kept, ``meta.json``'s JAX keys and counters;
    6. B's ``serve()`` against an engine built from B's weights: the same
       greedy tokens, the prefill and decode kernels launched;
    7. B's ``estimate_step_flops`` with the flash kernels against the
       dense model's.

    Prints save and load ms, the tags' bytes, the step that an async
    save's write overlaps beside the same step in B (no save in flight),
    and the phase's seconds."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke-ckpt-")
    try:
        out = run_checkpoint(ops, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def run_checkpoint(ops, root: str) -> dict:
    import os

    from stoke_tpu_torch.configs import CheckpointConfig, ServeConfig
    from stoke_tpu_torch.io_ops import checkpoint_tag
    from stoke_tpu_torch.serving import ServingEngine

    auto = os.path.join(root, "auto")
    auto_cfg = CheckpointConfig(save_every_n_steps=2, auto_path=auto,
                                max_to_keep=2, async_save=True)
    serve_cfg = ServeConfig(**{**SERVE, "max_new_tokens": 16},
                            attention="flash", decode_kernel="pallas")
    batches = window_batches(CKPT_MICRO)
    tags = {}

    # 1. run A: replayed steps with async auto-saves, a save mid-window
    a = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, grad_accum=2,
                  configs=[auto_cfg])
    ops.reset_launches()
    first, step_ms = [], []
    for i in range(4):
        sl = slice(2 * i, 2 * i + 2)
        step_ms.append(timed_ms(lambda: first.extend(
            a.train_steps(batches[sl], batches[sl])[:, 0].tolist())))
    a.train_step(batches[8], batches[8])
    save_ms = timed_ms(lambda: tags.update(mid=a.save(root, name="ckpt")))
    saver, saver_ms = eager_steps(a, batches[9:14])
    wait_ms = timed_ms(a.wait_for_checkpoint)
    launches = flash_launches(ops, N_LAYERS * 14, "checkpoint phase, run A")
    auto_tags = sorted(os.listdir(auto))
    want_tags = sorted([checkpoint_tag("auto", 8), checkpoint_tag("auto", 12)])
    with open(os.path.join(tags["mid"], "meta.json")) as f:
        meta = json.load(f)
    bookkeeping = {"auto_tags": auto_tags, "meta_keys": sorted(meta),
                   "meta_counters": meta["counters"],
                   "mid_tag_files": sorted(os.listdir(tags["mid"]))}
    if (auto_tags != want_tags
            or bookkeeping["meta_keys"] != ["counters", "format", "name",
                                            "status"]
            or meta["counters"] != {"backward_step": 9, "grad_accum_step": 1,
                                    "optimizer_step": 4}):
        raise AssertionError(f"checkpoint bookkeeping: {bookkeeping}")

    # 2. run B resumes the mid-window tag
    b = stoke_for(gpt_base("flash", init_seed=SEED + 1), "bf16", TRAIN_BATCH,
                  grad_accum=2, seed=1, configs=[serve_cfg])
    if masters_equal(a, b):
        raise AssertionError("runs A and B start from the same weights")
    load_ms = timed_ms(lambda: b.load(root, tag=os.path.basename(
        tags["mid"])))
    counters = (b.backward_steps, b.optimizer_steps, b.grad_accum_counter)
    resumed, resumed_ms = eager_steps(b, batches[9:14])
    resume = {"counters_after_load": counters, "losses_saver": saver,
              "losses_resumed": resumed,
              "masters_equal": masters_equal(a, b)}
    if (counters != (9, 4, 1) or resumed != saver
            or not resume["masters_equal"]):
        raise AssertionError(f"mid-window resume: {resume}")
    sync_ms = timed_ms(lambda: tags.update(sync=b.save(root, name="sync")))

    # 6. serve() against an engine built directly from B's weights
    prompts = [np.random.default_rng(SEED + i).integers(
        0, VOCAB, size=n).astype(np.int32) for i, n in enumerate(
            (17, 64, 129, 300))]

    def greedy(engine):
        rids = [engine.submit(p) for p in prompts]
        engine.run()
        return [list(engine.result(r).tokens) for r in rids]

    ops.reset_launches()
    served = greedy(b.serve())
    serve_launches = dict(ops.LAUNCHES)
    direct = greedy(ServingEngine(gpt_base("flash"),
                                  b.model_access.state_dict(), serve_cfg,
                                  device="cuda"))
    if served != direct or not (serve_launches["paged_decode"]
                                and serve_launches["flash_fwd"]):
        raise AssertionError(f"serve(): tokens {served} vs {direct}, "
                             f"launches {serve_launches}")

    # 7. the step's FLOPs: flash kernels by their formula against dense
    flops_flash = b.estimate_step_flops(batches[0], batches[0])
    dense = stoke_for(gpt_base("dense"), "bf16", TRAIN_BATCH)
    flops_dense = dense.estimate_step_flops(batches[0], batches[0])
    del dense, b
    torch.cuda.empty_cache()
    if flops_flash != flops_dense:
        raise AssertionError(f"estimate_step_flops: flash {flops_flash} "
                             f"vs dense {flops_dense}")

    # 3. a load under a captured window against a fresh run's
    c = stoke_for(gpt_base("flash", init_seed=SEED + 2), "bf16",
                  TRAIN_BATCH, grad_accum=2, seed=2, configs=[auto_cfg])
    newest = (c.maybe_resume(), c.optimizer_steps)
    if newest != (True, 6):
        raise AssertionError(f"maybe_resume picked {newest}, expected the "
                             f"step-6 tag")
    windows = list(a._engine._windows.values())
    step4 = checkpoint_tag("auto", 8)
    a.load(auto, tag=step4)
    window = batches[14:16]
    replayed = a.train_steps(window, window)[:, 0].tolist()
    kept = [x is y for x, y in zip(windows, a._engine._windows.values())]
    c.load(auto, tag=step4)
    fresh = c.train_steps(window, window)[:, 0].tolist()
    captured = {"windows_kept": bool(windows) and all(kept),
                "losses_replayed": replayed, "losses_fresh": fresh,
                "masters_equal": masters_equal(a, c)}
    if replayed != fresh or not captured["masters_equal"]:
        raise AssertionError(f"load under a captured window: {captured}")
    del a, c
    torch.cuda.empty_cache()

    # 4. fp16
    fp16 = fp16_resume(ops, root, batches)
    torch.cuda.empty_cache()
    return {
        "phase": "checkpoint", "model": "GPT-base, bf16 over fp32 masters, "
        "flash attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0, "
        "grad_accum 2", "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "launches": launches,
        "train_steps_ms": step_ms,
        "train_steps_ms_note": "steps 2 and 4 include their async "
        "auto-save's copy to the host; step 3 runs while step 2's tag is "
        "written",
        "losses_first_steps": first,
        "save_async_ms": save_ms, "save_async_write_wait_ms": wait_ms,
        "save_sync_ms": sync_ms, "load_ms": load_ms,
        "tag_bytes_mid_window": tag_bytes(tags["mid"]),
        "tag_bytes_boundary": tag_bytes(tags["sync"]),
        "overlapped_step_ms": saver_ms[0],
        "same_step_without_save_ms": resumed_ms[0],
        "saver_micro_ms": saver_ms, "resumed_micro_ms": resumed_ms,
        "bookkeeping": bookkeeping, "resume": resume,
        "load_under_captured_window": captured,
        "maybe_resume": {"resumed": newest[0], "optimizer_steps": newest[1]},
        "serve": {"tokens_equal_direct_engine": True,
                  "tokens": [len(t) for t in served],
                  "launches": serve_launches},
        "flops": {"flash": flops_flash, "dense": flops_dense},
        "fp16": fp16,
    }


# --------------------------------------------------------------------------- #
# phases 11 and 12: the vision models
# --------------------------------------------------------------------------- #


RESNET_BATCH = 256
VIT_BATCH, VIT_STEPS = 64, 8
STATS = ("running_mean", "running_var")


def cifar_pool(n: int, batch: int = RESNET_BATCH, side: int = 32,
               classes: int = 10, seed: int = 0) -> tuple:
    """``n`` batches as ``bench.py`` makes its pool: N(0, 1) NHWC images and
    labels below ``classes`` from ``default_rng(seed)``, batch by batch;
    returned NCHW on the card, ``[n, batch, 3, side, side]`` and
    ``[n, batch]``."""
    r = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        xs.append(r.normal(size=(batch, side, side, 3)).astype(np.float32))
        ys.append(r.integers(0, classes, size=(batch,)))
    x = torch.from_numpy(np.stack(xs)).cuda().permute(0, 1, 4, 2, 3)
    return x.contiguous(), torch.from_numpy(np.stack(ys)).cuda()


def softmax_ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels.long())


def resnet50_stoke():
    """ResNet-50 v1.5 (stages 3, 4, 6, 3; 64 stem filters; bottleneck x4),
    the CIFAR stem, 10 classes, channels_last, through ``Stoke`` in bf16
    over fp32 masters with SGD(0.05, momentum 0.9): ``bench.py``'s
    configuration."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=10, cifar_stem=True,
                     device="cuda").to(memory_format=torch.channels_last)
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05,
                                       momentum=0.9),
                 softmax_ce, batch_size_per_device=RESNET_BATCH,
                 precision="bf16")


def bn_stats(stoke) -> dict:
    return {k: v.clone() for k, v in stoke.model_access.state_dict().items()
            if k.endswith(STATS)}


def memory_formats(stoke, x) -> dict:
    """Whether the input, the stem's weight and its output are
    channels_last in a forward (in eval mode, which leaves the running
    statistics as they are)."""
    model = stoke.model_access
    seen = {}
    hook = model.conv_init.register_forward_hook(
        lambda m, i, o: seen.update(input=i[0], output=o))
    stoke.eval()
    stoke.model(x)
    stoke.train()
    hook.remove()
    fmt = lambda t: ("channels_last" if t.is_contiguous(
        memory_format=torch.channels_last) else "contiguous")
    return {"input_given": fmt(x), "input_seen": fmt(seen["input"]),
            "conv_weight": fmt(model.conv_init.weight),
            "conv_output": fmt(seen["output"])}


def step_flops(x, y) -> int:
    """FLOPs of one bf16 ``train_step`` of a fresh ResNet-50 by
    ``torch.utils.flop_counter`` (its convolutions and products, forward
    and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    stoke = resnet50_stoke()
    with FlopCounterMode(display=False) as counter:
        stoke.train_step(x, y)
    torch.cuda.synchronize()
    return int(counter.get_total_flops())


def throughput(ms, flops: int, batch: int) -> dict:
    """Step ms p50 over all but the first two steps, images/s and the
    share of the bf16 dense peak (``mfu``) at that p50."""
    p50 = float(np.median(ms[WARMUP_STEPS:]))
    return {"step_ms_p50": p50, "step_ms": ms,
            "images_per_s": batch / (p50 / 1e3),
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS[BF16]}


def train_resnet50(ops) -> dict:
    """ResNet-50 in bf16 at batch 256 on CIFAR-shaped images: the first
    batch of ``bench.py``'s pool, every step (the bench cycles four; on
    random labels only a batch seen again and again lets the loss fall
    within 12 steps): 12 eager ``train_step``s (2 warm-up), then
    ``train_steps`` over the same 12 batches from the same seed (one
    window eagerly, its capture, replays).
    Gates: the replayed losses and the running statistics equal the eager
    ones bit for bit, the statistics moved, the loss falls, two eval-mode
    forwards give the same logits; no flash kernel launches. Then 12
    timed replays of one window each; a profiled step of each kind."""
    pool_x, pool_y = cifar_pool(n=1)
    n = WARMUP_STEPS + TIMED_STEPS
    xs, ys = pool_x[[0] * n], pool_y[[0] * n]
    a = resnet50_stoke()
    first = bn_stats(a)
    formats = memory_formats(a, xs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eager, eager_ms = [], []
    for x, y in zip(xs, ys):
        eager_ms.append(timed_ms(lambda: eager.append(a.train_step(x, y))))
    eager = [float(l) for l in eager]
    eager_peak = torch.cuda.max_memory_allocated()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"ResNet-50 launched {dict(ops.LAUNCHES)}")
    eager_stats = bn_stats(a)
    moved = sum(not torch.equal(eager_stats[k], first[k]) for k in first)
    if moved != len(first):
        raise AssertionError(f"{len(first) - moved} of {len(first)} "
                             f"running statistics did not move")
    if not (all(np.isfinite(eager)) and np.mean(eager[-3:]) < eager[0]):
        raise AssertionError(f"ResNet-50 losses {eager}: not finite or not "
                             f"falling")
    eager_profile = profile_step(lambda: a.train_step(xs[0], ys[0]))
    a.eval()
    with torch.no_grad():
        same_eval = torch.equal(a.model(xs[0]), a.model(xs[0]))
    if not same_eval:
        raise AssertionError("two eval-mode forwards gave other logits")
    del a
    torch.cuda.empty_cache()

    b = resnet50_stoke()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    first_ms = timed_ms(lambda: out.update(r=b.train_steps(xs, ys)))
    graphed = out["r"][:, 0].tolist()
    graph_stats = bn_stats(b)
    stats_equal = all(torch.equal(graph_stats[k], eager_stats[k])
                      for k in eager_stats)
    if graphed != eager or not stats_equal:
        raise AssertionError(
            f"ResNet-50 replayed windows: losses {graphed} vs eager "
            f"{eager}; running statistics bit for bit: {stats_equal}")
    replay_ms = [timed_ms(lambda: b.train_steps(xs[i:i + 1], ys[i:i + 1]))
                 for i in range(n)]
    replay_peak = torch.cuda.max_memory_allocated()
    replay_profile = profile_step(lambda: b.train_steps(xs[:1], ys[:1]))
    del b, out
    torch.cuda.empty_cache()
    flops = step_flops(xs[0], ys[0])
    torch.cuda.empty_cache()
    top5 = lambda p: p.get("top", [])[:5]
    return {
        "phase": "train_resnet50", "model": "ResNet-50 v1.5 (3, 4, 6, 3 "
        "bottlenecks, 64 stem filters), CIFAR stem, 10 classes, "
        "channels_last, bf16 over fp32 masters, SGD(lr 0.05, momentum "
        "0.9), softmax cross entropy", "batch": RESNET_BATCH,
        "image": [3, 32, 32], "steps": n, "memory_format": formats,
        "step_flops": flops, "peak_flops_bf16": PEAK_FLOPS[BF16],
        "eager": {**throughput(eager_ms, flops, RESNET_BATCH),
                  "max_memory_allocated_gib": eager_peak / 2**30,
                  "device_busy_share": eager_profile.get(
                      "device_busy_share", "not measured"),
                  "top5": top5(eager_profile), "profile": eager_profile},
        "replayed": {**throughput(replay_ms, flops, RESNET_BATCH),
                     "max_memory_allocated_gib": replay_peak / 2**30,
                     "device_busy_share": replay_profile.get(
                         "device_busy_share", "not measured"),
                     "top5": top5(replay_profile),
                     "profile": replay_profile},
        "train_steps_first_call_ms": first_ms,
        "losses_eager": eager, "losses_replayed": graphed,
        "losses_bit_identical": True, "running_stats_bit_identical": True,
        "running_stats_moved": moved, "eval_logits_repeat": same_eval,
    }


def train_vit(ops) -> dict:
    """ViT-Base/16 (12 layers, hidden 768, 12 heads, MLP 3072, patch 16),
    224x224 seeded images, 1000 classes, dropout 0.1, dense attention, in
    bf16 over fp32 masters with AdamW(3e-4, wd 1e-4), batch 64: eager
    ``train_step``s over a pool of two batches cycled; the loss falls."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.models import ViTBase

    model = ViTBase(num_classes=1000, device="cuda")
    stoke = Stoke(model, StokeOptimizer(torch.optim.AdamW, lr=3e-4,
                                        weight_decay=1e-4),
                  softmax_ce, batch_size_per_device=VIT_BATCH,
                  precision="bf16", seed=SEED)
    xs, ys = cifar_pool(n=2, batch=VIT_BATCH, side=224, classes=1000,
                        seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, ms = [], []
    for i in range(VIT_STEPS):
        x, y = xs[i % 2], ys[i % 2]
        ms.append(timed_ms(lambda: losses.append(stoke.train_step(x, y))))
    losses = [float(l) for l in losses]
    peak = torch.cuda.max_memory_allocated()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"ViT (dense attention) launched "
                             f"{dict(ops.LAUNCHES)}")
    if not (all(np.isfinite(losses)) and np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"ViT losses {losses}: not finite or not "
                             f"falling")
    del stoke, model
    torch.cuda.empty_cache()
    return {"phase": "train_vit", "model": "ViT-Base/16 (12 x 768, 12 "
            "heads, MLP 3072), 224x224, 1000 classes, dropout 0.1, dense "
            "attention, bf16 over fp32 masters, AdamW(lr 3e-4, wd 1e-4)",
            "batch": VIT_BATCH, "steps": VIT_STEPS, "losses": losses,
            "step_ms": ms, "step_ms_p50": float(np.median(
                ms[WARMUP_STEPS:])),
            "images_per_s": VIT_BATCH / (np.median(ms[WARMUP_STEPS:]) / 1e3),
            "max_memory_allocated_gib": peak / 2**30}


# --------------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------------- #


# --------------------------------------------------------------------------- #
# phase 13: BERT-base sequence classification on bucketed ragged batches
# --------------------------------------------------------------------------- #


BERT_SIZE = "base"
BERT_VOCAB, BERT_MAX_LEN, BERT_CLASSES = 30522, 512, 2
BERT_BATCH, BERT_PAD, BERT_BUCKETS, BERT_SEQS = 32, 32, 8, 8192
BERT_MICRO = 40          # bf16 micro-steps: 20 optimizer steps
BERT_PARITY_MICRO = 6    # fp32: 3 optimizer steps at grad_accum=2
BERT_KERNEL_LENS = (32, 96, 512)
BERT_MARKERS = 16        # first-token markers; the label is the marker's parity
# the run as a document (``examples/bert_seqcls/train.py``'s flags); the
# card machine may have no PyYAML, so a dict. The learning rate is BERT's
# published pre-training rate, 1e-4: at the example's 3e-4 BERT-base
# returns to chance (ln 2) within these 20 steps, in bf16 through the
# kernels and in fp32 through dense attention alike, from either init
# (``scripts/port_probe_bert.py --sweep``)
BERT_DOC = {
    "batch_size_per_device": BERT_BATCH, "grad_accum": 2, "precision": "bf16",
    "grad_clip": {"type": "norm", "max_norm": 1.0},
    "optimizer": {"name": "adamw", "learning_rate": 1.0e-4}, "seed": 0,
}
# BERT's published initializer: N(0, 0.02^2) weights and embeddings
BERT_INIT_STD = 0.02


def bert_corpus(n: int = BERT_SEQS, seed: int = SEED):
    """The BERT example's synthetic data at BERT-base's length cap:
    lengths ``(Pareto(2.5) + 1) x 8`` clipped to [8, 512], tokens uniform
    in [5 + BERT_MARKERS, vocab); the first token is one of BERT_MARKERS
    marker ids and the label its parity, so a model reading the [CLS]
    row can learn the task within the phase."""
    r = np.random.default_rng(seed)
    lens = np.clip((r.pareto(2.5, size=n) + 1.0) * 8, 8,
                   BERT_MAX_LEN).astype(int)
    markers = r.integers(0, BERT_MARKERS, size=n)
    seqs = []
    for L, m in zip(lens, markers):
        s = r.integers(5 + BERT_MARKERS, BERT_VOCAB, size=L).astype(np.int32)
        s[0] = 5 + m
        seqs.append(s)
    return seqs, (markers % 2).astype(np.int64)


def padded_len(lengths) -> int:
    return -(-int(np.max(lengths)) // BERT_PAD) * BERT_PAD


def padding_share(lengths, batches) -> float:
    """Pad tokens over all tokens when each batch pads to its longest,
    rounded up to BERT_PAD."""
    real = pad = 0
    for idx in batches:
        n = int(lengths[idx].sum())
        real += n
        pad += padded_len(lengths[idx]) * len(idx) - n
    return pad / (pad + real)


def gather_pad_ms(ds, batches, native: bool) -> float:
    """Host ms a batch of ``gather_pad`` (the C++ batcher or numpy)."""
    from stoke_tpu_torch.native import NativeBatcher

    b = NativeBatcher(native=native)
    t0 = time.perf_counter()
    for idx in batches:
        b.gather_pad(ds.ragged, ds.offsets, ds.lengths, idx,
                     pad_multiple=BERT_PAD)
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    b.close()
    return ms


def bert_kernel_masks(lengths, batches) -> dict:
    """For each L of BERT_KERNEL_LENS, ``(mask [32, L], source)``: the key
    mask of a batch of the bucketed epoch padded to L, or, where none is
    (the Pareto tail seldom reaches 512), the epoch's longest batch with
    its lengths stretched so that its longest is L."""
    by_len = {}
    for idx in batches:
        by_len.setdefault(padded_len(lengths[idx]), idx)
    longest = by_len[max(by_len)]
    out = {}
    for L in BERT_KERNEL_LENS:
        if L in by_len:
            lens, source = lengths[by_len[L]], "epoch batch"
        else:
            base = lengths[longest].astype(np.float64)
            lens = np.maximum(1, np.round(base * L / base.max())).astype(int)
            source = f"longest batch ({max(by_len)}) stretched"
        mask = (np.arange(L)[None] < np.asarray(lens)[:, None]).astype(
            np.int32)
        out[L] = (torch.from_numpy(mask).cuda(), source)
    return out


def enqueue_ms(fn, n: int = 20) -> float:
    """Host ms a call of ``fn`` spends before it returns (its launches
    enqueued, the card not waited for): a wrapper's host work, such as
    the tensor maps the 16-bit flash kernels encode for each call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def bert_kernel_case(ops, gen, flush, mask, source: str) -> dict:
    """The three flash kernels at BERT-base's attention shape in bf16:
    B=32, H=12, D=64, non-causal, ``mask`` [32, L] from a bucketed batch.
    The forward against ``flash_attention_plain`` within FWD_ATOL_BF16;
    dQ, dK and dV against ``flash_attention_bwd_plain`` within
    BWD_RTOL_BF16 of the largest element and BWD_ROW_RTOL_BF16 a row
    (``bwd_row_err``), masked keys exactly 0 in dK and dV; each timed
    beside its plain version and SDPA with the same boolean mask (the
    backward: SDPA's backward alone, replayed from a graph)."""
    dev = torch.device("cuda")
    B, L = mask.shape
    q, k, v, do = (torch.randn(B, HEADS, L, HEAD_DIM, generator=gen,
                               device=dev).to(BF16) for _ in range(4))
    out, lse = ops.flash_attention(q, k, v, mask, causal=False,
                                   return_lse=True)
    ref_out, ref_lse = ops.flash_attention_plain(q, k, v, mask, False)
    delta = (do.float() * out.float()).sum(-1)
    dq = ops.flash_bwd_dq(q, k, v, mask, do, lse, delta, False)
    dk, dv = ops.flash_bwd_dkv(q, k, v, mask, do, lse, delta, False)
    ref = ops.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, None,
                                        False)
    torch.cuda.synchronize()
    name = f"bert flash L={L} bf16 non-causal masked"
    fwd_err = max(max_err(out, ref_out), max_err(lse, ref_lse))
    if not (torch.isfinite(out).all() and fwd_err <= ops.FWD_ATOL_BF16):
        raise AssertionError(f"{name}: forward |kernel - plain| {fwd_err} > "
                             f"{ops.FWD_ATOL_BF16}")
    errs = {n: max_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                (dq, dk, dv), ref)}
    tols = {n: ops.BWD_RTOL_BF16 * float(r.float().abs().max())
            for n, r in zip(errs, ref)}
    rows = {n: ops.bwd_row_err(a, b)
            for n, a, b in zip(errs, (dq, dk, dv), ref)}
    finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    if (not finite or any(errs[n] > tols[n] for n in errs)
            or max(rows.values()) > ops.BWD_ROW_RTOL_BF16):
        raise AssertionError(f"{name}: backward |kernel - plain| {errs} "
                             f"(bounds {tols}), rows {rows} (bound "
                             f"{ops.BWD_ROW_RTOL_BF16}), finite {finite}")
    dead = (mask == 0)[:, None, :, None]
    if bool((dk * dead).abs().max() > 0) or bool((dv * dead).abs().max() > 0):
        raise AssertionError(f"{name}: masked keys have nonzero dK or dV")
    allow = mask[:, None, None, :] > 0
    pairs = HEADS * allowed_pairs(B, L, mask, False)
    tile = B * HEADS * L * HEAD_DIM * q.element_size()
    stats = 2 * B * HEADS * L * 4
    mask_bytes = mask.numel() * 4
    bf = bound_ms(4 * tile + B * HEADS * L * 4 + mask_bytes,
                  4.0 * HEAD_DIM * pairs, BF16)
    bq = bound_ms(5 * tile + stats + mask_bytes, 6.0 * HEAD_DIM * pairs, BF16)
    bkv = bound_ms(6 * tile + stats + mask_bytes, 8.0 * HEAD_DIM * pairs,
                   BF16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "B": B, "L": L, "D": HEAD_DIM, "causal": False, "masked": True,
        "mask_source": source, "dtype": "bfloat16",
        "real_keys_share": float(mask.float().mean()),
        "fwd": {"max_abs_err": fwd_err, "atol": ops.FWD_ATOL_BF16,
                "ms": time_ms(lambda: ops.flash_attention(
                    q, k, v, mask, causal=False), 20, flush),
                "plain_ms": time_ms(lambda: ops.flash_attention_plain(
                    q, k, v, mask, False), 5, flush),
                "library_ms": time_ms(lambda: sdpa(q, k, v, attn_mask=allow),
                                      20, flush),
                "enqueue_ms": enqueue_ms(lambda: ops.flash_attention(
                    q, k, v, mask, causal=False)),
                "bound_ms": bf[0], "bound_by": bf[1]},
        "bwd": {"max_abs_err": errs, "tol": tols, "row_rel_err": rows,
                "dq_ms": time_ms(lambda: ops.flash_bwd_dq(
                    q, k, v, mask, do, lse, delta, False), 10, flush),
                "dkv_ms": time_ms(lambda: ops.flash_bwd_dkv(
                    q, k, v, mask, do, lse, delta, False), 10, flush),
                "plain_ms": time_ms(lambda: ops.flash_attention_bwd_plain(
                    q, k, v, mask, out, lse, do, None, False), 5, flush),
                "library_ms": sdpa_backward_ms(q, k, v, do, False, flush,
                                               attn_mask=allow),
                "enqueue_ms": {
                    "dq": enqueue_ms(lambda: ops.flash_bwd_dq(
                        q, k, v, mask, do, lse, delta, False)),
                    "dkv": enqueue_ms(lambda: ops.flash_bwd_dkv(
                        q, k, v, mask, do, lse, delta, False))},
                "dq_bound_ms": bq[0], "dq_bound_by": bq[1],
                "dkv_bound_ms": bkv[0], "dkv_bound_by": bkv[1]},
    }


@torch.no_grad()
def bert_init_(model, seed: int, std: float = BERT_INIT_STD) -> None:
    """BERT's published initialization (Devlin et al. 2019,
    ``initializer_range``): weights and embeddings from N(0, std^2),
    biases 0, LayerNorm scale 1, drawn by a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=model.pooler.weight.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if ".ln_" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=gen)


def bert_base(attention: str, init_seed: int = SEED, init: str = "bert"):
    """BERT-base at its published widths (12 x 768, 12 heads, ff 3072,
    vocab 30522, max_len 512), 2 classes, on the card, weights seeded by
    ``init_seed`` from BERT's initializer (``init="bert"``) or flax's
    defaults (``"flax"``, the JAX module's); dropout 0 (the flash kernels
    take no dropout of the attention probabilities); ``attention``
    "flash" (non-causal, the padding mask as the key mask) or "dense"."""
    from stoke_tpu_torch.models.bert import (
        BertForSequenceClassification,
        dense_attention,
    )
    from stoke_tpu_torch.ops import make_flash_attention

    model = BertForSequenceClassification(
        vocab_size=BERT_VOCAB, num_classes=BERT_CLASSES, size_name=BERT_SIZE,
        max_len=BERT_MAX_LEN, dropout_rate=0.0,
        attention_fn=(make_flash_attention(causal=False)
                      if attention == "flash" else dense_attention),
        device="cuda")
    if init == "bert":
        bert_init_(model, init_seed)
    else:
        model.init_weights(init_seed)
    return model


def bert_loss(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def bert_micro_step(stoke, batch, labels) -> float:
    """The four calls on one micro-batch; returns the undivided loss."""
    loss = stoke.loss(stoke.model(batch["input_ids"],
                                  batch["attention_mask"]), labels)
    stoke.backward(loss)
    stoke.step()
    return float(loss) * stoke.grad_accum


def train_bert(ops) -> dict:
    """BERT-base sequence classification end to end: a document through
    ``stoke_from_config``, ragged batches gathered and padded by the
    native batcher in the bucketed sampler's order, the flash kernels
    non-causal under the padding mask at ragged L, the four calls."""
    import tempfile

    from stoke_tpu_torch.data import (
        BucketedDistributedSampler,
        RaggedSequenceDataset,
    )
    from stoke_tpu_torch.native import NativeBatcher
    from stoke_tpu_torch.utils.tb_writer import read_scalar_events
    from stoke_tpu_torch.utils.yaml_config import stoke_from_config

    t_phase = time.perf_counter()
    seqs, labels = bert_corpus()
    ds = RaggedSequenceDataset(seqs, labels, pad_multiple=BERT_PAD)
    sampler = BucketedDistributedSampler(
        ds, buckets=BERT_BUCKETS, batch_size=BERT_BATCH,
        sorted_idx=ds.sorted_idx(), num_replicas=1, rank=0, seed=SEED,
        info_rank=-1)
    epoch = np.fromiter(iter(sampler), np.int64).reshape(-1, BERT_BATCH)
    shuffled = np.random.default_rng(SEED).permutation(len(ds))
    shuffled = shuffled[:len(ds) // BERT_BATCH * BERT_BATCH].reshape(
        -1, BERT_BATCH)
    if not NativeBatcher().available:
        raise AssertionError("the C++ batcher did not build (g++)")
    padding = {"bucketed": padding_share(ds.lengths, epoch),
               "shuffled": padding_share(ds.lengths, shuffled),
               "epoch_padded_lens": sorted({padded_len(ds.lengths[i])
                                            for i in epoch})}
    gather = {"native_ms": gather_pad_ms(ds, epoch[:64], True),
              "numpy_ms": gather_pad_ms(ds, epoch[:64], False)}

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = [bert_kernel_case(ops, gen, flush, mask, source) for mask, source
             in bert_kernel_masks(ds.lengths, epoch).values()]
    del flush
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="stoke-bert-tb-") as tb_dir:
        doc = {**BERT_DOC, "configs": {"TensorboardConfig": {
            "output_path": tb_dir, "log_every_n_steps": 5}}}
        stoke = stoke_from_config(bert_base("flash"), bert_loss, None, doc)
        loader = stoke.DataLoader(ds, sampler=sampler)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses, times, lens, real = [], [], [], []
        for i, (batch, y) in enumerate(loader):
            if i == BERT_MICRO:
                break
            t0 = time.perf_counter()
            losses.append(bert_micro_step(stoke, batch, y))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            lens.append(int(batch["input_ids"].shape[1]))
            real.append(int(batch["attention_mask"].sum()))
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        native_batches = loader.native_batches
        stoke._tb_writer.flush()
        events = [e for f in sorted(os.listdir(os.path.join(tb_dir, "stoke")))
                  for e in read_scalar_events(os.path.join(tb_dir, "stoke",
                                                           f))]
        steps = stoke.optimizer_steps
        # one optimizer step (two micro-steps) at L=512, profiled
        mask512 = bert_kernel_masks(ds.lengths, epoch)[512][0]
        ids512 = torch.randint(5, BERT_VOCAB, mask512.shape, device="cuda",
                               dtype=torch.int32, generator=gen) * mask512
        y512 = torch.zeros(BERT_BATCH, dtype=torch.int64, device="cuda")
        batch512 = {"input_ids": ids512, "attention_mask": mask512}
        profile = profile_step(lambda: [bert_micro_step(stoke, batch512, y512)
                                        for _ in range(2)])
        del stoke, loader
    torch.cuda.empty_cache()

    want = N_LAYERS * BERT_MICRO
    if any(launches[n] != want for n in FLASH):
        raise AssertionError(f"train_bert launches {launches}: each flash "
                             f"kernel {want} times ({N_LAYERS} layers x "
                             f"{BERT_MICRO} micro-steps)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_bert: non-finite loss {losses}")
    if not np.mean(losses[-5:]) < min(np.mean(losses[:5]), 0.5 * np.log(2)):
        raise AssertionError(f"train_bert: the loss did not fall below the "
                             f"first five's mean and half of chance (ln 2): "
                             f"{losses}")
    if any(L % BERT_PAD or L > BERT_MAX_LEN for L in lens):
        raise AssertionError(f"train_bert: batch lengths {lens}")
    if native_batches < BERT_MICRO:
        raise AssertionError(f"train_bert: {native_batches} batches "
                             f"assembled natively, expected >= {BERT_MICRO}")
    if steps != BERT_MICRO // 2:
        raise AssertionError(f"train_bert: {steps} optimizer steps")
    logged = {(t, s): v for t, v, s in events}
    want_steps = list(range(5, steps + 1, 5))
    for s in want_steps:
        micro = np.float32(losses[2 * s - 1])
        if logged.get(("loss/micro", s)) != float(micro) or not np.isfinite(
                logged.get(("loss/ema", s), np.nan)):
            raise AssertionError(f"train_bert: event file at step {s}: "
                                 f"{logged.get(('loss/micro', s))} against "
                                 f"the micro loss {float(micro)}")

    parity = bert_parity(ops, ds, sampler)
    timed = slice(WARMUP_STEPS, None)
    by_len = {}
    for L, t in zip(lens[timed], times[timed]):
        by_len.setdefault(L, []).append(t * 1e3)
    total = sum(times[timed])
    return {
        "phase": "train_bert",
        "model": "BERT-base seq-cls (12 x 768, 12 heads, ff 3072, vocab "
        "30522, max_len 512, 2 classes), bf16 over fp32 masters, flash "
        "attention non-causal under the padding mask, AdamW(1e-4) from a "
        "document (stoke_from_config), clip norm 1.0, grad_accum 2, BERT's "
        "N(0, 0.02) init",
        "batch": BERT_BATCH, "micro_steps": BERT_MICRO,
        "optimizer_steps": steps, "document": BERT_DOC,
        "sequences": BERT_SEQS, "buckets": BERT_BUCKETS,
        "losses": losses, "batch_lens": lens, "launches": launches,
        "native_batches": native_batches,
        "logged_steps": want_steps,
        "step_ms_p50_by_len": {str(L): float(np.median(v))
                               for L, v in sorted(by_len.items())},
        "steps_by_len": {str(L): len(v) for L, v in sorted(by_len.items())},
        "real_tokens_per_s": sum(real[timed]) / total,
        "padded_tokens_per_s": BERT_BATCH * sum(lens[timed]) / total,
        "padding_share": padding, "gather_pad": gather,
        "max_memory_allocated_gib": peak / 2**30,
        "profile_l512": {
            **profile,
            "flash_share_of_kernels": (
                profile["attention_kernels_ms"] / profile["device_ms"]
                if isinstance(profile.get("device_ms"), float)
                else "not measured")},
        "kernel_cases": cases, "parity": parity,
        "seconds": time.perf_counter() - t_phase,
    }


def bert_parity(ops, ds, sampler) -> dict:
    """BERT-base in fp32 for 3 optimizer steps (grad_accum=2) on the
    bucketed epoch's first batches, through the flash kernels (3xTF32) and
    through dense attention, from the same seeded weights: the losses
    within PARITY_RTOL relative."""
    from stoke_tpu_torch.data import StokeDataLoader
    from stoke_tpu_torch.utils.yaml_config import stoke_from_config

    sampler.set_epoch(1)
    batches = []
    for i, b in enumerate(StokeDataLoader(ds, BERT_BATCH, device="cuda",
                                          sampler=sampler)):
        if i == BERT_PARITY_MICRO:
            break
        batches.append(b)
    runs, launches = {}, {}
    for attention in ("flash", "dense"):
        stoke = stoke_from_config(bert_base(attention), bert_loss, None,
                                  {**BERT_DOC, "precision": None})
        ops.reset_launches()
        runs[attention] = [bert_micro_step(stoke, b, y) for b, y in batches]
        launches[attention] = {n: ops.LAUNCHES[n] for n in FLASH}
        del stoke
        torch.cuda.empty_cache()
    want = N_LAYERS * BERT_PARITY_MICRO
    if any(launches["flash"][n] != want for n in FLASH) or any(
            launches["dense"].values()):
        raise AssertionError(f"bert parity launches {launches}")
    rel = rel_diff(runs["flash"], runs["dense"])
    if not rel <= PARITY_RTOL:
        raise AssertionError(f"bert parity: kernels {runs['flash']} vs "
                             f"dense {runs['dense']}: {rel} > {PARITY_RTOL}")
    return {"precision": "fp32", "micro_steps": BERT_PARITY_MICRO,
            "batch_lens": [int(b["input_ids"].shape[1]) for b, _ in batches],
            "losses_kernels": runs["flash"], "losses_dense": runs["dense"],
            "max_rel_diff": rel, "rtol": PARITY_RTOL, "launches": launches}


# --------------------------------------------------------------------------- #
# phase 14: the DP / ZeRO ladder in a one-process NCCL group
# --------------------------------------------------------------------------- #


#: the tiers, as ``Stoke`` flags under ``distributed="dp"``
DP_TIERS = {"dp": {}, "oss": dict(oss=True),
            "oss_sddp": dict(oss=True, sddp=True), "fsdp": dict(fsdp=True)}
DP_EAGER_STEPS, DP_WINDOWS, DP_TIMED_WINDOWS = 4, 8, 6
DP_SEGMENT = 4
#: device kernels of NCCL's collectives (on one rank NCCL runs an
#: averaging all-reduce as its ``onerank`` kernel, a summing one, a
#: reduce-scatter or an all-gather as a device copy or nothing)
NCCL_KERNEL_MARKS = ("nccl", "onerank")
DP_RESNET_BATCH, DP_RESNET_STEPS = 64, 4
#: four units of bf16's rounding, relative to each statistic's largest
#: magnitude (``tests/test_torch_vision_train.py``'s bound)
DP_BN_TOL = 4 * 2.0**-7


def collective_profile(step) -> dict:
    """One call of ``step`` under ``torch.profiler``: NCCL's device
    kernels by name (launches) and its host calls (``nccl:*`` ranges) by
    name, beside the step's device busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, calls, device_ms, nccl_ms, copy_ms = {}, {}, 0.0, 0.0, 0.0
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device_ms += ms
            if any(m in e.key.lower() for m in NCCL_KERNEL_MARKS):
                kernels[e.key[:90]] = e.count
                nccl_ms += ms
            elif "Memcpy DtoD" in e.key:
                copy_ms += ms
        elif e.device_type == DeviceType.CPU and e.key.startswith("nccl:"):
            calls[e.key] = calls.get(e.key, 0) + e.count
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "nccl_kernel_launches": sum(kernels.values()),
            "nccl_kernel_ms": nccl_ms, "memcpy_dtod_ms": copy_ms,
            "nccl_kernels": kernels, "nccl_calls": calls}


def four_call_step(stoke, batch) -> torch.Tensor:
    loss = stoke.loss(stoke.model(batch), batch)
    stoke.backward(loss)
    stoke.step()
    return loss


def master_max_diff(a, b) -> float:
    """The largest difference between two runs' parameters."""
    with a._whole_params(), b._whole_params():
        return max(float((x.detach().float() - y.detach().float()).abs()
                         .max()) for x, y in
                   zip(a.model_access.parameters(),
                       b.model_access.parameters()))


def dp_parity(ops) -> dict:
    """GPT-base in fp32 at B=2, L=512 (the ``train_parity`` shapes, the
    fp32 flash kernels): 3 four-call steps under each tier against the
    run without ``distributed`` from the same seed and batches."""
    corpus = torch.from_numpy(make_corpus(n=6, seq_len=512, vocab=VOCAB,
                                          seed=1)).cuda()
    batches = [corpus[i:i + 2] for i in range(0, 6, 2)]
    ref = stoke_for(gpt_base("flash"), None, 2)
    want = [float(four_call_step(ref, b)) for b in batches]
    out = {"losses_one_device": want, "tiers": {}}
    for tier, flags in DP_TIERS.items():
        s = stoke_for(gpt_base("flash"), None, 2, distributed="dp", **flags)
        got = [float(four_call_step(s, b)) for b in batches]
        rel = rel_diff(got, want)
        if not rel <= PARITY_RTOL:
            raise AssertionError(
                f"train_dp parity {tier}: losses {got} vs one device "
                f"{want}, max relative difference {rel} > {PARITY_RTOL}")
        out["tiers"][tier] = {"losses": got, "max_rel_diff": rel,
                              "max_param_abs_diff": master_max_diff(s, ref),
                              "world_size": s.world_size}
        del s
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    out["rtol"] = PARITY_RTOL
    return out


def dp_full_width(ops, tier: str, batches) -> dict:
    """GPT-base bf16 at B=8, L=1024 under one tier (``one_device``: no
    ``distributed``, the baseline of the same schedule): DP_EAGER_STEPS
    four-call steps, then ``train_steps`` over DP_WINDOWS batches in
    segments of DP_SEGMENT (the first window eagerly, its capture, then
    replays), then DP_TIMED_WINDOWS replayed windows timed one a call;
    a profiled eager step and a profiled replayed window. Then a second
    run of the same tier takes the same batches in eager four-call steps
    only, the reference of the windows' losses."""
    flags = ({} if tier == "one_device"
             else dict(distributed="dp", **DP_TIERS[tier]))
    s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, **flags)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eager, eager_ms = [], []
    for b in batches[:DP_EAGER_STEPS]:
        eager_ms.append(timed_ms(lambda: eager.append(four_call_step(s, b))))
    out, replayed = {}, []
    first_ms = timed_ms(lambda: out.update(seg=s.train_steps(
        batches[:DP_WINDOWS], batches[:DP_WINDOWS], segment_size=DP_SEGMENT)))
    replay_ms = [timed_ms(lambda: replayed.append(s.train_steps(
        batches[i:i + 1], batches[i:i + 1])))
                 for i in range(DP_TIMED_WINDOWS)]
    micro = DP_EAGER_STEPS + DP_WINDOWS + DP_TIMED_WINDOWS
    launches = flash_launches(ops, micro * N_LAYERS, f"train_dp {tier}")
    peak = torch.cuda.max_memory_allocated()
    windows_kept = len(s._engine._windows)
    eager_prof = collective_profile(lambda: four_call_step(s, batches[0]))
    replay_prof = collective_profile(
        lambda: s.train_steps(batches[:1], batches[:1]))
    losses = [float(l) for l in eager]
    segmented = out["seg"][:, 0].tolist()
    replayed = [float(r[0, 0]) for r in replayed]
    steps = s.optimizer_steps
    del s, out
    torch.cuda.empty_cache()
    ref = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, **flags)
    eager_ref = [float(four_call_step(ref, b)) for b in (
        *batches[:DP_EAGER_STEPS], *batches[:DP_WINDOWS],
        *batches[:DP_TIMED_WINDOWS])]
    del ref
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses + segmented + replayed)):
        raise AssertionError(f"train_dp {tier}: losses {losses}, "
                             f"{segmented}, {replayed}")
    if windows_kept < 1:
        raise AssertionError(f"train_dp {tier}: no window was captured")
    if tier != "one_device" and eager_prof["nccl_kernel_launches"] < 1:
        raise AssertionError(f"train_dp {tier}: the profiled step launched "
                             f"no NCCL kernel: {eager_prof}")
    return {"eager_step_ms_p50": float(np.median(eager_ms[1:])),
            "eager_step_ms": eager_ms,
            "replayed_step_ms_p50": float(np.median(replay_ms[1:])),
            "replayed_step_ms": replay_ms, "first_train_steps_ms": first_ms,
            "losses_eager": losses, "losses_segmented": segmented,
            "losses_replayed": replayed, "losses_eager_reference": eager_ref,
            "optimizer_steps": steps,
            "flash_launches": launches, "windows_captured": windows_kept,
            "max_memory_allocated_gib": peak / 2**30,
            "profile_eager": eager_prof, "profile_replayed": replay_prof}


def dp_window_parity(full: dict, world: int) -> None:
    """The losses of every run of ``dp_full_width``, in two checks; every
    difference is recorded before the first failure raises.

    - Each tier's (and ``one_device``'s) segmented and replayed windows
      against its own eager reference on the same batches, within
      WINDOW_RTOL: a replay runs the eager step's kernels in its order,
      so this holds the CUDA-graph captures of the ladder's collectives
      and of fsdp's storage frees and gathers to the eager step.
    - Each tier against ``one_device``: plain dp to the bit at world 1
      (the same arithmetic); the sharded tiers, and dp across ranks,
      within PARITY_RTOL, since they sum the clip norm's squares in
      another grouping and a last-bit change of a master can flip its
      bf16 rounding."""
    n_eager, n_seg = DP_EAGER_STEPS, DP_EAGER_STEPS + DP_WINDOWS
    failures = []
    for tier, run in full.items():
        ref = run["losses_eager_reference"]
        for key, want in (("losses_eager", ref[:n_eager]),
                          ("losses_segmented", ref[n_eager:n_seg]),
                          ("losses_replayed", ref[n_seg:])):
            diff = rel_diff(run[key], want)
            run[key.replace("losses", "rel_diff_to_eager")] = diff
            if not diff <= WINDOW_RTOL:
                failures.append(f"{tier}: {key} {run[key]} vs its eager "
                                f"steps {want}, {diff} > {WINDOW_RTOL}")
        if tier == "one_device":
            continue
        tol = 0.0 if world == 1 and tier == "dp" else PARITY_RTOL
        for key in ("losses_eager", "losses_segmented", "losses_replayed"):
            want = full["one_device"][key]
            diff = rel_diff(run[key], want)
            run[key.replace("losses", "rel_diff_to_one_device")] = diff
            if not diff <= tol:
                failures.append(f"{tier}: {key} {run[key]} vs one device "
                                f"{want}, {diff} > {tol} at world {world}")
    if failures:
        raise AssertionError("train_dp: " + "; ".join(failures))


def dp_resnet50() -> dict:
    """ResNet-50 bf16 from a ``stoke_from_config`` document with
    ``examples/cifar10/config/dp_oss_sddp.yaml``'s flags (dp, bf16, oss,
    sddp, batch 64, SGD(0.1, momentum 0.9)) on 32x32 images, against the
    same document without ``distributed`` and the tiers: DP_RESNET_STEPS
    ``train_step``s on the same seeded batches. BatchNorm's moments are
    all-reduced over the group; the running statistics must match within
    DP_BN_TOL of their largest magnitude."""
    from stoke_tpu_torch.models import ResNet50
    from stoke_tpu_torch.models.resnet import BatchNorm
    from stoke_tpu_torch.utils.yaml_config import stoke_from_config

    doc = {"batch_size_per_device": DP_RESNET_BATCH, "precision": "bf16",
           "optimizer": {"name": "sgd", "learning_rate": 0.1,
                         "momentum": 0.9}}
    dp_doc = {**doc, "distributed": "dp", "oss": True, "sddp": True}
    xs, ys = cifar_pool(n=DP_RESNET_STEPS, batch=DP_RESNET_BATCH)
    runs = {}
    for name, d in (("one_device", doc), ("dp_oss_sddp", dp_doc)):
        model = ResNet50(num_classes=10, cifar_stem=True,
                         device="cuda").to(memory_format=torch.channels_last)
        s = stoke_from_config(model, softmax_ce, None, d)
        synced = [m.sync_group is not None for m in model.modules()
                  if isinstance(m, BatchNorm)]
        losses = [float(s.train_step(x, y)) for x, y in zip(xs, ys)]
        stats = bn_stats(s)
        calls = ({} if name == "one_device" else collective_profile(
            lambda: s.train_step(xs[0], ys[0]))["nccl_calls"])
        runs[name] = {"losses": losses, "stats": stats,
                      "bn_layers": len(synced),
                      "bn_synced": all(synced) and bool(synced),
                      "tier": s.status.sharding_tier.value,
                      "nccl_calls": calls}
        del s, model
        torch.cuda.empty_cache()
    a, b = runs["dp_oss_sddp"], runs["one_device"]
    worst = max(float((a["stats"][k] - b["stats"][k]).abs().max()
                      / b["stats"][k].abs().max()) for k in b["stats"])
    if not a["bn_synced"] or b["bn_synced"]:
        raise AssertionError("train_dp resnet50: BatchNorm's all-reduce is "
                             "not on under dp (or on without it)")
    if not worst <= DP_BN_TOL:
        raise AssertionError(f"train_dp resnet50: running statistics differ "
                             f"by {worst} of their largest magnitude > "
                             f"{DP_BN_TOL}")
    # each BatchNorm all-reduces its moments in the forward and their
    # gradient in the backward
    if not a["nccl_calls"].get("nccl:all_reduce", 0) >= 2 * a["bn_layers"]:
        raise AssertionError(
            f"train_dp resnet50: {a['bn_layers']} BatchNorm layers but the "
            f"profiled step's all-reduces are {a['nccl_calls']}")
    return {"model": "ResNet-50 v1.5, CIFAR stem, 10 classes, "
            "channels_last, bf16", "batch": DP_RESNET_BATCH,
            "tier": a["tier"], "losses_dp": a["losses"],
            "losses_one_device": b["losses"],
            "running_stats_max_rel_diff": worst, "tol": DP_BN_TOL,
            "batchnorm_layers": a["bn_layers"],
            "nccl_calls_profiled_step": a["nccl_calls"]}


def train_dp(ops) -> dict:
    """The DP / ZeRO ladder in a one-process NCCL group (world 1: the card
    shows that the tiers run over NCCL, that their collectives launch and
    are captured in the replayed windows, and that the flash kernels run
    under each; nothing between ranks): GPT-base fp32 parity per tier,
    GPT-base bf16 at full width per tier, ResNet-50 from the dp_oss_sddp
    flags. At world 1 the ladder saves no memory."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    # the group is destroyed on failure too: NCCL's watchdog would
    # otherwise hold the process for minutes after the error
    try:
        parity = dp_parity(ops)
        batches = window_batches(max(DP_WINDOWS, DP_EAGER_STEPS,
                                     DP_TIMED_WINDOWS))
        full = {tier: dp_full_width(ops, tier, batches)
                for tier in ("one_device", *DP_TIERS)}
        del batches
        try:
            dp_window_parity(full, dist.get_world_size())
        finally:
            emit({"phase": "train_dp_losses", "runs": {
                t: {k: v for k, v in r.items()
                    if k.startswith(("losses", "rel_diff"))}
                for t, r in full.items()}})
        resnet = dp_resnet50()
        return {"phase": "train_dp", "backend": dist.get_backend(),
                "world_size": dist.get_world_size(),
                "model": "GPT-base (12 x 768, vocab 50257), flash attention",
                "parity_fp32_B2_L512": parity,
                "full_width_bf16_B8_L1024": full,
                "launches": {n: sum(full[t]["flash_launches"][n]
                                    for t in DP_TIERS) for n in FLASH},
                "resnet50": resnet, "seconds": time.perf_counter() - t0}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phase 15: the quantized gradient transports over the ladder
# --------------------------------------------------------------------------- #


#: (wire dtype or None, tier): int8 replicated (dp, oss) and sharded
#: (sddp, fsdp), bf16 and the fp32 pass-through under dp, and dp without
#: a ``CommConfig``, the fp32 transport's bit-for-bit reference
COMM_RUNS = (("int8", "dp"), ("int8", "oss"), ("int8", "oss_sddp"),
             ("int8", "fsdp"), ("bf16", "dp"), ("fp32", "dp"), (None, "dp"))
COMM_EAGER, COMM_WINDOWS, COMM_TIMED = 4, 4, 6
QUANT_NAMES = ("quantize_chunks", "dequantize_chunks")


def quant_profile(step) -> dict:
    """One call of ``step`` under ``torch.profiler``: the quantize pair's
    device ms and launches beside all kernels' device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device_ms, quant = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        device_ms += ms
        # "dequantize_chunks_kernel" contains "quantize_chunks_kernel"
        k = next((k for k in reversed(QUANT_KERNELS) if k in e.key), None)
        if k is not None:
            q = quant.setdefault(k, {"ms": 0.0, "calls": 0})
            q["ms"] += ms
            q["calls"] += e.count
    quant_ms = sum(q["ms"] for q in quant.values())
    return {"device_ms": device_ms, "quant_kernels": quant,
            "quant_ms": quant_ms,
            "quant_share": quant_ms / device_ms if device_ms else None}


def comm_run(ops, dtype, tier: str, batches) -> dict:
    """GPT-base bf16 at B=8, L=1024 in a one-process NCCL group under
    ``tier`` with ``CommConfig(dtype)`` (None: none): COMM_EAGER eager
    steps, ``train_steps`` over COMM_WINDOWS batches in segments of 2 (a
    window eagerly, its capture, replays), COMM_TIMED replayed windows
    timed one a call, a profiled replayed window; then a second run takes
    every batch in eager steps, the windows' reference."""
    from stoke_tpu_torch.configs import CommConfig

    configs = [] if dtype is None else [CommConfig(dtype=dtype)]
    mk = lambda: stoke_for(  # noqa: E731
        gpt_base("flash"), "bf16", TRAIN_BATCH, distributed="dp",
        configs=configs, **DP_TIERS[tier])
    s = mk()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eager, eager_ms = eager_steps(s, batches[:COMM_EAGER])
    seg = s.train_steps(batches[:COMM_WINDOWS], batches[:COMM_WINDOWS],
                        segment_size=2)[:, 0].tolist()
    replayed = []
    replay_ms = [timed_ms(lambda: replayed.append(float(s.train_steps(
        batches[i:i + 1], batches[i:i + 1])[0, 0])))
        for i in range(COMM_TIMED)]
    steps = COMM_EAGER + COMM_WINDOWS + COMM_TIMED
    launches = {n: ops.LAUNCHES[n] for n in (*QUANT_NAMES, *FLASH)}
    peak = torch.cuda.max_memory_allocated()
    windows_kept = len(s._engine._windows)
    prof = quant_profile(lambda: s.train_steps(batches[:1], batches[:1]))
    residual = [r.numel() for r in s._engine.comm_state.get("residual", [])]
    comm_bytes, kind = s.comm_bytes, (
        s._engine.transport.layout_kind
        if s._engine.transport.active else "none")
    del s
    torch.cuda.empty_cache()
    ref = mk()
    want, _ = eager_steps(ref, [*batches[:COMM_EAGER], *batches[:COMM_WINDOWS],
                                *batches[:COMM_TIMED]])
    del ref
    torch.cuda.empty_cache()
    got = eager + seg + replayed
    return {"dtype": dtype, "tier": tier, "transport": kind,
            "losses_eager": eager, "losses_segmented": seg,
            "losses_replayed": replayed, "losses_eager_reference": want,
            "windows_equal_eager": got == want,
            "eager_step_ms_p50": float(np.median(eager_ms[1:])),
            "replayed_step_ms_p50": float(np.median(replay_ms[1:])),
            "eager_step_ms": eager_ms, "replayed_step_ms": replay_ms,
            "launches": launches, "quant_launches_per_step": {
                n: launches[n] / steps for n in QUANT_NAMES},
            "windows_captured": windows_kept, "profile_replayed": prof,
            "residual_elems": residual, "comm_bytes": comm_bytes,
            "max_memory_allocated_gib": peak / 2**30}


def train_comm(ops) -> dict:
    """The gradient transports in a one-process NCCL group (world 1: the
    transports run their local round trip, so this shows the quantize
    kernels and their capture in the replayed windows, not the wire):
    COMM_RUNS through :func:`comm_run`. Gates: the fp32 transport's
    losses equal the run without ``CommConfig`` bit for bit; each run's
    segmented and replayed windows equal its eager steps bit for bit; the
    losses fall; the int8 runs launch the quantize pair every step."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        batches = window_batches(max(COMM_EAGER, COMM_WINDOWS, COMM_TIMED))
        runs = {f"{d}_{t}": comm_run(ops, d, t, batches)
                for d, t in COMM_RUNS}
        world = dist.get_world_size() if dist.is_initialized() else None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    failures = []
    for name, r in runs.items():
        if not r["windows_equal_eager"]:
            failures.append(f"{name}: windows {r['losses_segmented']} "
                            f"{r['losses_replayed']} vs eager "
                            f"{r['losses_eager_reference']}")
        # batch 0 again after COMM_EAGER + COMM_WINDOWS steps
        run = r["losses_eager_reference"]
        if not run[COMM_EAGER + COMM_WINDOWS] < run[0]:
            failures.append(f"{name}: the loss on batch 0 did not fall: "
                            f"{run}")
        if r["dtype"] == "int8" and not all(
                v >= 1 for v in r["quant_launches_per_step"].values()):
            failures.append(f"{name}: quant launches {r['launches']}")
        if r["dtype"] in (None, "fp32", "bf16") and any(
                r["launches"][n] for n in QUANT_NAMES):
            failures.append(f"{name}: quant kernels launched {r['launches']}")
    if runs["fp32_dp"]["losses_eager_reference"] != runs[
            "None_dp"]["losses_eager_reference"]:
        failures.append("the fp32 transport's losses differ from the run "
                        "without CommConfig")
    if failures:
        raise AssertionError("train_comm: " + "; ".join(failures))
    return {"phase": "train_comm", "world_size": world,
            "model": "GPT-base (12 x 768, vocab 50257), bf16, flash "
            "attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0",
            "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
            "note": "world 1: the local round trip, no wire", "runs": runs,
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in QUANT_NAMES},
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------- #
# phase 16: checkpoints across the tiers and both formats
# --------------------------------------------------------------------------- #


#: the depth of the checkpoint_dp runs (the tag's bytes are mostly the
#: embedding's at any depth; 16 saves and loads of the full depth would
#: take the phase's time)
CKPT_DP_LAYERS = 2
#: micro-batches (grad_accum=2): 3 before the mid-window save, 1 to end
#: that window, then 3 windows in one ``train_steps`` (eager, captured,
#: replayed)
CKPT_DP_BEFORE, CKPT_DP_WINDOWS = 3, 3


def checkpoint_dp_case(tier: str, fmt: str, is_async: bool, root: str,
                       batches) -> dict:
    """One (tier, format, sync or async): a run saves mid-window and
    trains on (eagerly, then windows replayed); a fresh run loads the tag
    and trains the same batches; their losses must be equal bit for
    bit."""
    import shutil

    from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat

    cfg = CheckpointConfig(format=CheckpointFormat(fmt), async_save=is_async)
    mk = lambda: stoke_for(  # noqa: E731
        gpt_base("flash", layers=CKPT_DP_LAYERS), "bf16", TRAIN_BATCH,
        grad_accum=2, distributed="dp", configs=[cfg], **DP_TIERS[tier])
    n_win = 2 * CKPT_DP_WINDOWS
    after = batches[CKPT_DP_BEFORE:CKPT_DP_BEFORE + 1]
    windows = batches[CKPT_DP_BEFORE + 1:CKPT_DP_BEFORE + 1 + n_win]

    def go_on(s):
        losses = [float(four_call_step(s, b)) for b in after]
        return losses + s.train_steps(windows, windows).reshape(-1).tolist()

    s = mk()
    for b in batches[:CKPT_DP_BEFORE]:
        four_call_step(s, b)
    save_ms = timed_ms(lambda: s.save(root))
    wait_ms = timed_ms(s.wait_for_checkpoint)
    tag = os.path.join(root, os.listdir(root)[0])
    nbytes = tag_bytes(tag)
    with open(os.path.join(tag, "meta.json")) as f:
        meta = json.load(f)
    want = go_on(s)
    del s
    torch.cuda.empty_cache()
    r = mk()
    load_ms = timed_ms(lambda: r.load(root))
    counter = r.grad_accum_counter
    got = go_on(r)
    windows_kept = len(r._engine._windows)
    del r
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return {"tier": tier, "format": fmt, "async": is_async,
            "save_ms": save_ms, "write_wait_ms": wait_ms, "load_ms": load_ms,
            "tag_bytes": nbytes, "meta_format": meta["format"],
            "counter_after_load": counter, "windows_captured": windows_kept,
            "losses_unbroken": want, "losses_resumed": got,
            "bit_for_bit": got == want}


def checkpoint_dp(ops) -> dict:
    """Every tier x {consolidated, sharded} x {sync, async} in a
    one-process NCCL group, GPT-base bf16 cut to CKPT_DP_LAYERS blocks:
    save mid-window, load into a fresh run, continue eagerly and in
    replayed windows, bit for bit against the run that saved."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="stoke_ckpt_dp_")
    cases = []
    try:
        batches = window_batches(CKPT_DP_BEFORE + 1 + 2 * CKPT_DP_WINDOWS)
        for tier in DP_TIERS:
            for fmt in ("consolidated", "sharded"):
                for is_async in (False, True):
                    cases.append(checkpoint_dp_case(
                        tier, fmt, is_async,
                        os.path.join(base, f"{tier}_{fmt}_{is_async}"),
                        batches))
        world = dist.get_world_size() if dist.is_initialized() else None
    finally:
        shutil.rmtree(base, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    bad = [c for c in cases if not c["bit_for_bit"]
           or c["counter_after_load"] != 1]
    if bad:
        raise AssertionError(f"checkpoint_dp: resumed runs differ: {bad}")
    return {"phase": "checkpoint_dp", "world_size": world,
            "model": f"GPT-base cut to {CKPT_DP_LAYERS} blocks (768 wide, "
            f"vocab 50257), bf16, grad_accum=2",
            "cases": cases, "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------- #
# phase 17: int8 and bf16 serving weights
# --------------------------------------------------------------------------- #


def forced_agreement(engine, plain, prompts, plain_streams,
                     streams) -> dict:
    """``engine``'s greedy choice scored on ``plain``'s streams: each
    request's prompt and plain stream through both engines' weights in
    one full-sequence forward; ``agreement`` is the share of the stream's
    tokens whose argmax under ``engine`` is the plain token. At the first
    token where a free-running stream of ``engine`` leaves the plain one:
    the plain top-2 logit gap there and the largest logit change, and
    whether the change can flip the tie (gap <= 2 x change)."""
    agree = total = 0
    divergences = []
    with torch.inference_mode():
        for i, (prompt, want, got) in enumerate(zip(prompts, plain_streams,
                                                    streams)):
            ids = torch.tensor([list(prompt) + list(want[:-1])],
                               device="cuda")
            lo = len(prompt) - 1
            lq = engine._forward(ids)[0, lo:].float()
            lp = plain._forward(ids)[0, lo:].float()
            agree += int((lq.argmax(-1).cpu() == torch.tensor(want)).sum())
            total += len(want)
            j = next((t for t, (a, b) in enumerate(zip(want, got))
                      if a != b), None)
            if j is None:
                continue
            top = torch.topk(lp[j], 2).values
            gap = float(top[0] - top[1])
            change = float((lq[j] - lp[j]).abs().max())
            divergences.append({"request": i, "token": j, "top2_gap": gap,
                                "max_logit_change": change,
                                "near_tie": gap <= 2 * change})
    return {"agreement": agree / total, "divergences": divergences}


def serve_quant(ops) -> dict:
    """The ``serve`` trace (GPT-base fp32, 16 requests in three waves, 8
    slots, 32 new tokens, the flash and decode kernels) with
    ``quant="int8"`` and ``quant="bf16"`` beside the plain engine. Gates
    (int8): compression >= 3.5x over the quantized leaves; the greedy
    choice agreeing with the plain engine's on >= 99% of the tokens it
    emitted, each scored on the plain stream's context (a free-running
    stream that flips one near-tie continues on another context, so its
    every later token counts as a disagreement; that agreement is
    reported beside it), and every point where a free-running int8
    stream leaves the plain one a near-tie that the int8 logits'
    perturbation can flip (plain top-2 gap <= 2 x the largest logit
    change there); and the dequantize kernel launched once a quantized
    leaf every dispatch."""
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine
    from stoke_tpu_torch.serving.quant import QuantizedTensor, param_bytes

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, model.vocab_size, size=int(n)) for n in lens]
    base = dict(attention="flash", decode_kernel="pallas", **SERVE)
    out, streams, engines = {"phase": "serve_quant"}, {}, {}
    for mode in ("none", "int8", "bf16"):
        cfg = ServeConfig(quant=mode, **base)
        ServingEngine(GPT(size_name="base", device="cuda"), weights,
                      cfg).generate([prompts[0][:16]], 2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        engine = ServingEngine(GPT(size_name="base", device="cuda"), weights,
                               cfg)
        torch.cuda.synchronize()
        built = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        # the other engines, the seed model and the weights stay allocated
        # across the loop: the engine's own peak is its build plus what
        # its drive added above the memory in use at the reset
        at_reset = torch.cuda.memory_allocated()
        ops.reset_launches()
        streams[mode], wall = drive(engine, prompts)
        drive_peak = torch.cuda.max_memory_allocated() - at_reset
        summary = engine.summary()
        launches = {n: ops.LAUNCHES[n] for n in
                    ("dequantize_chunks", "quantize_chunks", "flash_fwd",
                     "paged_decode")}
        dispatches = summary["decode_steps"] + summary["prefills"]
        quantized = ({n: v for n, v in engine.qparams.items()
                      if isinstance(v, QuantizedTensor)}
                     if engine.qparams else {})
        leaf_fp = sum(weights[n].numel() * weights[n].element_size()
                      for n in quantized)
        row = {"tokens_out": summary["tokens_out"], "wall_s": wall,
               "tokens_per_s": summary["tokens_out"] / wall,
               "tpot_p50_s": summary["tpot_p50_s"],
               "tpot_p99_s": summary["tpot_p99_s"],
               "ttft_p50_s": summary["ttft_p50_s"],
               "dispatches": dispatches, "launches": launches,
               "param_bytes": param_bytes(engine.qparams or weights),
               "engine_bytes_on_device": built,
               "engine_peak_gib": (built + drive_peak) / 2**30,
               "drive_peak_above_rest_gib": drive_peak / 2**30,
               "process_peak_gib": (torch.cuda.max_memory_allocated()
                                    / 2**30),
               "quantized_leaves": len(quantized),
               "compression": (engine.quant_stats or {}).get("compression")}
        if quantized:
            row["compression_quantized_leaves"] = leaf_fp / param_bytes(
                quantized)
            worst = max(engine.quant_errors.items(),
                        key=lambda kv: kv[1]["rel_rms"], default=None)
            row["worst_leaf_rel_rms"] = worst
        out[mode] = row
        engines[mode] = engine
    for mode in ("int8", "bf16"):
        pairs = [(a, b) for sa, sb in zip(streams[mode], streams["none"])
                 for a, b in zip(sa, sb)]
        out[mode]["stream_agreement"] = (sum(a == b for a, b in pairs)
                                         / len(pairs))
        out[mode].update(forced_agreement(
            engines[mode], engines["none"], prompts, streams["none"],
            streams[mode]))
    del engines
    torch.cuda.empty_cache()
    q = out["int8"]
    want = q["quantized_leaves"] * q["dispatches"]
    if not q["compression_quantized_leaves"] >= 3.5:
        raise AssertionError(f"serve_quant: int8 compression {q}")
    if not q["agreement"] >= 0.99:
        raise AssertionError(f"serve_quant: int8's greedy choice agrees on "
                             f"{q['agreement']} of the tokens")
    if not all(d["near_tie"] for d in q["divergences"]):
        raise AssertionError(f"serve_quant: an int8 stream left the plain "
                             f"one where no near-tie explains it: "
                             f"{q['divergences']}")
    if q["launches"]["dequantize_chunks"] != want:
        raise AssertionError(
            f"serve_quant: dequantize launched {q['launches']} times, "
            f"expected {q['quantized_leaves']} leaves x {q['dispatches']} "
            f"dispatches")
    if out["bf16"]["launches"]["dequantize_chunks"] or out["none"][
            "launches"]["dequantize_chunks"]:
        raise AssertionError(f"serve_quant: dequantize launched without "
                             f"int8: {out}")
    out["launches"] = {"dequantize_chunks": q["launches"]["dequantize_chunks"]}
    out["model"] = ("GPT-base (12 x 768, vocab 50257), fp32, seeded random "
                    "weights")
    return out


# --------------------------------------------------------------------------- #
# phases 19-20: resilience and offload
# --------------------------------------------------------------------------- #

#: the uninterrupted run: RES_EAGER eager steps, then train_steps windows
#: of RES_SEGMENT steps each up to RES_STEPS
RES_STEPS, RES_EAGER, RES_SEGMENT = 12, 3, 3
#: dropout on the embeddings and residuals, so the resumed runs depend on
#: the restored generator state
RES_DROPOUT = 0.1
#: the periodic saves of the lives and the supervised worker (the first
#: life's preemption lands on one), and of the "on" run
RES_SAVE_EVERY, RES_ON_SAVE_EVERY = 3, 6
#: the supervised worker: SIGKILLed after step RES_KILL_AT (a periodic
#: sync tag of that step lands just before), RES_WORKER_STEPS steps
RES_KILL_AT, RES_WORKER_STEPS = 3, 6
#: depth of the corruption, partial-tag and elastic cases (each writes and
#: reads tags; the tag's bytes are mostly the embedding's at any depth)
RES_SHORT_LAYERS = 2
#: the CPU world that writes the elastic case's tag, and its batch
ELASTIC_WORLD, ELASTIC_BATCH, ELASTIC_LEN = 2, 2, 32
ELASTIC_COMM = dict(dtype="int8", shard_updates=True)
RES_TIMEOUT_S = 300


def masters_digest(stoke) -> str:
    """sha256 over the fp32 masters' bytes, in the module's order (fsdp's
    gathered whole)."""
    import hashlib

    h = hashlib.sha256()
    with stoke._whole_params():
        for p in stoke.model_access.parameters():
            h.update(p.detach().to("cpu", copy=True).numpy().tobytes())
    return h.hexdigest()


def res_stoke(root: str, tag: str, layers: int = N_LAYERS,
              init_seed: int = SEED, resilience: bool = True,
              periodic: str = None, chaos: str = None, extra=(),
              every: int = RES_SAVE_EVERY, **flags):
    """GPT-base bf16 with dropout RES_DROPOUT for the resilience phase:
    a ResilienceConfig under ``root/tag/em`` (when ``resilience``), and a
    periodic save every ``every`` steps under ``root/tag/auto``
    (``periodic``: "staged" async through pinned memory, or "sync")."""
    import os

    from stoke_tpu_torch.configs import CheckpointConfig, ResilienceConfig

    configs = list(extra)
    if resilience:
        configs.append(ResilienceConfig(
            save_path=os.path.join(root, tag, "em"), exit_on_preempt=False,
            chaos=chaos))
    if periodic is not None:
        staged = periodic == "staged"
        configs.append(CheckpointConfig(
            async_save=staged, offload_staging=staged, max_to_keep=2,
            save_every_n_steps=every,
            auto_path=os.path.join(root, tag, "auto")))
    return stoke_for(gpt_base("flash", RES_DROPOUT, layers,
                              init_seed=init_seed), "bf16", TRAIN_BATCH,
                     seed=SEED, configs=configs, **flags)


def res_segment(stoke, batches, first: int, last: int) -> list:
    """Steps ``first``..``last`` (1-based) as one ``train_steps`` call;
    returns their losses."""
    seg = batches[first - 1:last]
    return [float(v) for v in stoke.train_steps(seg, seg).reshape(-1)]


def res_schedule(stoke, batches, start: int = 0,
                 stop: int = RES_STEPS) -> dict:
    """The reference schedule from optimizer step ``start`` to ``stop``:
    eager ``train_step``s up to RES_EAGER, then one ``train_steps`` call
    a RES_SEGMENT steps (the first window of the first call eager and
    captured, every later one a replay); returns the losses by step and
    the masters' digests at steps RES_WORKER_STEPS and RES_STEPS (what
    the resumed runs are held to)."""
    losses, digests = {}, {}
    step = start
    while step < min(stop, RES_EAGER):
        losses[step + 1] = float(stoke.train_step(batches[step],
                                                  batches[step]))
        step += 1
    while step < stop:
        last = min(step + RES_SEGMENT, stop)
        for i, v in enumerate(res_segment(stoke, batches, step + 1, last)):
            losses[step + 1 + i] = v
        step = last
        if step in (RES_WORKER_STEPS, RES_STEPS):
            digests[step] = masters_digest(stoke)
    return {"losses": losses, "digests": digests}


#: timed steps of the off / on runs after the schedule: one-window
#: replays, then eager steps; a step that crosses a periodic save is
#: reported apart (the save's own cost is ``save_stall``'s)
RES_TIMED = 6


def res_timed(stoke, batches) -> dict:
    """RES_TIMED one-window ``train_steps`` replays, then RES_TIMED eager
    ``train_step``s, each timed (no save in flight when each begins);
    the p50 of each kind over the steps that cross no periodic save,
    and the times of those that do."""
    out = {}
    for kind in ("replayed", "eager"):
        stoke.wait_for_checkpoint()
        first = stoke.optimizer_steps + 1
        ms = []
        for i in range(RES_TIMED):
            b = batches[i:i + 1]
            if kind == "replayed":
                ms.append(timed_ms(lambda: stoke.train_steps(b, b)))
            else:
                ms.append(timed_ms(lambda: stoke.train_step(b[0], b[0])))
        every = stoke.checkpoint_config.save_every_n_steps or 0
        saves = [bool(every) and (first + i) % every == 0
                 for i in range(len(ms))]
        out[f"{kind}_ms"] = ms
        out[f"{kind}_ms_p50"] = float(np.median(
            [m for m, sv in zip(ms, saves) if not sv]))
        out[f"{kind}_save_step_ms"] = [m for m, sv in zip(ms, saves) if sv]
    stoke.wait_for_checkpoint()
    return out


def flash_delta(ops, before: dict) -> dict:
    return {n: ops.LAUNCHES[n] - before[n] for n in FLASH}


def save_stall(stoke, root: str, staged: bool, cold: bool = False) -> dict:
    """One async save of ``stoke``: the host ms the call holds the
    training thread (no synchronize after: the staged copies run on a
    side stream), then the write's ms (``wait_for_checkpoint``); the
    peak device bytes above those held before the save, across the save
    and its write (the decoupling copy of a staged one); the pinned
    bytes the Stoke's staging pool holds after it, and torch's pinned
    host allocator's current bytes (before the save too). ``cold``: the
    pool closed and torch's cache of unused pinned blocks emptied first
    (an earlier snapshot's blocks sit there), so the save allocates its
    pinned buffers as a process's first staged save does."""
    import dataclasses

    from stoke_tpu_torch import offload

    cfg = dataclasses.replace(stoke.checkpoint_config, async_save=True,
                              offload_staging=staged, max_to_keep=1)
    if cold:
        stoke._staging_pool.close()
        stoke._staging_pool = offload.PinnedPool()
        offload._empty_host_cache()

    def host_gib():
        return {k: v / 2**30 for k, v in torch.cuda.host_memory_stats(
        ).items() if "bytes" in k and k.endswith("current")}

    host_before = host_gib()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stoke._save_with_config(root, "stall", cfg, None)
    stall = (time.perf_counter() - t0) * 1e3
    write = timed_ms(stoke.wait_for_checkpoint)
    return {"staged": staged, "cold_pool": cold, "stall_ms": stall,
            "write_ms": write,
            "peak_above_held_gib": (torch.cuda.max_memory_allocated()
                                    - held) / 2**30,
            "pinned_pool_gib": stoke._staging_pool.nbytes / 2**30,
            "host_allocator_gib_before": host_before,
            "host_allocator_gib": host_gib(),
            "host_empty_cache": hasattr(torch._C, "_host_emptyCache")}


#: the stall runs, in order: (staged, cold pool); plain and warm staged
#: interleaved twice, so a difference in write time shows against noise
STALL_RUNS = ((False, False), (True, True), (True, False), (False, False),
              (True, False))


def staged_snapshot_check(stoke, batch) -> dict:
    """A staged snapshot of the masters and the AdamW state taken just
    before an optimizer step that updates them in place, resolved after
    it: bit for bit the pre-step state (a torn copy would hold post-step
    bytes)."""
    from stoke_tpu_torch import offload

    params = list(stoke.model_access.parameters())
    live = {f"p{i}": p for i, p in enumerate(params)}
    for i, p in enumerate(params):
        for k, v in stoke.optimizer.state[p].items():
            if torch.is_tensor(v) and v.dim():
                live[f"s{i}/{k}"] = v
    before = {k: v.detach().clone() for k, v in live.items()}
    snap = offload.stage_tree(live)
    stoke.train_step(batch, batch)
    spec, leaves = snap.resolve()
    got = torch.utils._pytree.tree_unflatten(leaves, spec)
    changed = sum(not torch.equal(live[k], before[k]) for k in live)
    bad = [k for k in live
           if got[k].tobytes() != before[k].cpu().numpy().tobytes()]
    snap.release()
    if bad or not changed:
        raise AssertionError(f"staged snapshot: {len(bad)} tensors differ "
                             f"from the pre-step state ({bad[:3]}), "
                             f"{changed} changed by the step")
    return {"tensors": len(live), "changed_by_the_step": changed,
            "bit_equal_pre_step": True,
            "bytes": int(sum(v.numel() * v.element_size()
                             for v in before.values()))}


def resilience_worker(argv) -> int:
    """``chip_smoke.py --resilience-worker <dir> [--partial]``: one life
    of the supervised run (GPT-base, periodic sync saves, resume at
    start, the reference schedule to RES_WORKER_STEPS, appending its
    losses, digests and seconds to ``<dir>/lives.jsonl``); with
    ``--partial`` the 2-block run whose staged async save at step
    RES_SAVE_EVERY the fault injector kills."""
    import os

    t0 = time.perf_counter()
    root = argv[0]
    partial = "--partial" in argv
    from stoke_tpu_torch import ops

    before = dict(ops.LAUNCHES)
    s = res_stoke(os.path.dirname(root), os.path.basename(root),
                  layers=RES_SHORT_LAYERS if partial else N_LAYERS,
                  periodic="staged" if partial else "sync")
    resumed = s.resume()
    start = s.optimizer_steps
    # the reference run's batches (the corpus depends on their number)
    batches = window_batches(RES_STEPS)
    if partial:
        for b in batches[:RES_SAVE_EVERY]:
            s.train_step(b, b)
        s.wait_for_checkpoint()  # the injector kills the writer here
        return 1
    out = res_schedule(s, batches, start, RES_WORKER_STEPS)
    s.wait_for_checkpoint()
    s.close_telemetry()
    with open(os.path.join(root, "lives.jsonl"), "a") as f:
        f.write(json.dumps({
            "attempt": int(os.environ.get("STOKE_RESTART_ATTEMPT", "0")),
            "resumed": resumed, "start": start, "losses": out["losses"],
            "digests": out["digests"], "launches": flash_delta(ops, before),
            "seconds": time.perf_counter() - t0}) + "\n")
    return 0


def elastic_rank(rank: int, world: int, store: str, root: str) -> None:
    """One rank of the CPU gloo world that writes the elastic case's tag:
    GPT-base width at RES_SHORT_LAYERS blocks, sddp with the int8 sharded
    transport, two steps, a preemption noticed on rank 0 and the
    emergency save at step 3."""
    import traceback

    from stoke_tpu_torch.configs import (CommConfig, DistributedInitConfig,
                                         ResilienceConfig)
    from stoke_tpu_torch.parallel import initialize_distributed
    from stoke_tpu_torch.resilience import PreemptedError

    torch.set_num_threads(2)
    try:
        initialize_distributed(DistributedInitConfig(
            coordinator_address=f"file://{store}", num_processes=world,
            process_id=rank), torch.device("cpu"))
        model = gpt_base("flash", 0.0, RES_SHORT_LAYERS, device="cpu")
        s = stoke_for(model, "bf16", ELASTIC_BATCH, device="cpu",
                      distributed="dp", oss=True, sddp=True, configs=[
                          CommConfig(**ELASTIC_COMM),
                          ResilienceConfig(save_path=root,
                                           exit_on_preempt=False)])
        g = torch.Generator().manual_seed(rank)
        for step in range(3):
            b = torch.randint(0, VOCAB, (ELASTIC_BATCH, ELASTIC_LEN),
                              generator=g, dtype=torch.int32)
            if step == 2 and rank == 0:
                s.resilience.request_preemption("elastic")
            try:
                s.train_step(b, b)
            except PreemptedError:
                break
        else:
            raise AssertionError("elastic: no preemption at step 3")
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"error.rank{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def start_elastic_world(root: str):
    """Spawn the CPU world of :func:`elastic_rank` (in the background)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "store")
    procs = [ctx.Process(target=elastic_rank,
                         args=(r, ELASTIC_WORLD, store, root))
             for r in range(ELASTIC_WORLD)]
    for p in procs:
        p.start()
    return procs


def join_procs(procs, what: str, deadline: float) -> None:
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{what}: exit codes "
                             f"{[p.exitcode for p in procs]} "
                             f"({len(alive)} killed at the deadline)")


def elastic_resume(ops, root: str) -> dict:
    """The CPU world's tag resumed at world 1 on the card (a one-process
    NCCL group): the parameters and the AdamW state as saved, the
    residual remapped onto world 1's padding exactly as
    ``remap_residual`` maps the saved one on the host; two steps launch
    the quantize pair."""
    import pickle

    import torch.distributed as dist

    from stoke_tpu_torch.configs import CommConfig, ResilienceConfig
    from stoke_tpu_torch.io_ops import load_checkpoint
    from stoke_tpu_torch.parallel.zero import remap_residual
    from stoke_tpu_torch.resilience import list_checkpoints

    (cand,) = list_checkpoints(root, "emergency")
    with open(os.path.join(cand["tag_dir"], "extras.pkl"), "rb") as f:
        rs = pickle.load(f)["resilience"]
    with open(os.path.join(cand["tag_dir"], "meta.json")) as f:
        counters = json.load(f)["counters"]
    try:
        s = stoke_for(gpt_base("flash", 0.0, RES_SHORT_LAYERS,
                               init_seed=SEED + 7), "bf16", TRAIN_BATCH,
                      distributed="dp", oss=True, sddp=True, configs=[
                          CommConfig(**ELASTIC_COMM),
                          ResilienceConfig(save_path=root,
                                           exit_on_preempt=False)])
        if not s.resume():
            raise AssertionError("elastic: resume() found no tag")
        desc = s._comm_layout()
        want = remap_residual(rs["comm_state"]["residual"],
                              rs["comm_layout"], desc)
        live = [r.cpu().numpy() for r in s._engine.comm_state["residual"]]
        residual_equal = len(want) == len(live) and all(
            a.tobytes() == b.tobytes() for a, b in zip(want, live))
        nonzero = int(sum(np.count_nonzero(a) for a in live))
        # the masters against the tag's arrays
        tag_vars = np.load(os.path.join(cand["tag_dir"], "variables.npz"))
        masters_equal_tag = all(
            np.array_equal(p.detach().cpu().numpy(), tag_vars[n])
            for n, p in s.model_access.named_parameters())
        before = {n: ops.LAUNCHES[n] for n in QUANT_NAMES + FLASH}
        batches = window_batches(2)
        losses = [float(s.train_step(b, b)) for b in batches]
        launches = {n: ops.LAUNCHES[n] - before[n] for n in before}
        summary = s.resilience_summary
        s.close_telemetry()
        del s
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    failures = []
    if not residual_equal or not nonzero:
        failures.append(f"residual equal {residual_equal}, nonzero "
                        f"{nonzero}")
    if not masters_equal_tag:
        failures.append("the masters differ from the tag's")
    if summary["elastic_resumes"] != 1:
        failures.append(f"elastic resumes {summary['elastic_resumes']}")
    if not all(launches[n] >= 2 for n in QUANT_NAMES + FLASH):
        failures.append(f"launches {launches}")
    if not np.all(np.isfinite(losses)):
        failures.append(f"losses {losses}")
    if failures:
        raise AssertionError("elastic: " + "; ".join(failures))
    return {"saved_world": rs["comm_layout"]["world"],
            "saved_buckets": rs["comm_layout"]["buckets"],
            "resumed_buckets": desc["buckets"],
            "saved_step": counters["optimizer_step"],
            "residual_equal_host_remap": residual_equal,
            "residual_nonzero": nonzero,
            "masters_equal_tag": masters_equal_tag,
            "elastic_resume": summary["elastic_resume"],
            "losses": losses, "launches": launches}


def train_resilience(ops) -> dict:
    """Preemption-safe training on GPT-base bf16 (B=8, L=1024, 12 blocks,
    dropout 0.1, flash attention, AdamW, clip 1.0), in a temporary
    directory removed at the end:

    1. off against on: the reference schedule (3 eager steps, then
       ``train_steps`` of 3) without configs and with a
       ``ResilienceConfig`` and a periodic async save staged through
       pinned memory every 6 steps: dispatches, flash launches, losses
       and masters equal; eager and replayed step ms p50;
    2. a staged snapshot held bit for bit across the step that follows
       it; the async save's stall, write and peak device bytes, plain
       and staged (cold and warm pinned pool);
    3. in the background: the supervised run (``python -m
       stoke_tpu_torch.supervise`` over ``chip_smoke.py
       --resilience-worker`` with ``kill_at_step=3,kill_mode=sigkill``),
       the killed-save run (``kill_during_save=1``) and the CPU gloo
       world that writes the elastic tag;
    4. in-process preemption: life 1 preempted at an eager step (the
       staged periodic save of that step in flight), life 2 resumes
       (other initial weights) and is preempted by a SIGTERM that lands
       while its replayed windows run, life 3 resumes to the end: losses
       and masters bit for bit against the reference, flash launches in
       every life;
    5. ``corrupt_save=2`` (2 blocks): resume quarantines the newest tag
       and falls back;
    6. the background runs: the supervised lives against the reference
       bit for bit with each life's seconds; the killed save's partial
       tag quarantined by ``resume()``; the elastic resume
       (:func:`elastic_resume`)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke-res-")
    bg = []
    try:
        out = run_resilience(ops, root, bg)
    finally:
        for p in bg:
            if getattr(p, "poll", None) is not None and p.poll() is None:
                p.kill()
                p.wait()
            elif getattr(p, "is_alive", None) is not None and p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def run_resilience(ops, root: str, bg: list) -> dict:
    """:func:`train_resilience`'s body; ``bg`` collects the background
    processes, which the caller stops if this raises."""
    import signal
    import threading

    from stoke_tpu_torch.resilience import CHAOS_ENV, PreemptedError

    batches = window_batches(RES_STEPS)
    failures = []
    sections = {}
    t_sec = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        sections[name] = now - t_sec[0]
        t_sec[0] = now

    # 1. off against on
    runs = {}
    for name, kw in (("off", dict(resilience=False)),
                     ("on", dict(periodic="staged",
                                 every=RES_ON_SAVE_EVERY))):
        before = dict(ops.LAUNCHES)
        s = res_stoke(root, name, **kw)
        sched = res_schedule(s, batches)
        s.wait_for_checkpoint()
        sched.update(launches=flash_delta(ops, before),
                     dispatches=s.dispatch_count,
                     timed=res_timed(s, batches),
                     digest=masters_digest(s))
        runs[name] = (s, sched)
    off, ref = runs["off"][1], runs["on"][1]
    for key in ("losses", "digests", "launches", "dispatches"):
        if off[key] != ref[key]:
            failures.append(f"off vs on: {key} {off[key]} vs {ref[key]}")
    if off["digest"] != ref["digest"]:
        failures.append("off vs on: masters after the replays differ")
    on_stoke = runs["on"][0]
    auto_tags = sorted(os.listdir(os.path.join(root, "on", "auto")))
    del runs["on"], on_stoke
    section("off_vs_on")
    # 2. the staged snapshot; the stall, plain and staged
    s_off = runs.pop("off")[0]
    snapshot = staged_snapshot_check(s_off, batches[0])
    stall = [save_stall(s_off, os.path.join(root, "stall"), staged, cold)
             for staged, cold in STALL_RUNS]
    del s_off
    torch.cuda.empty_cache()
    section("snapshot_and_stall")
    # 3. the background runs
    import stoke_tpu_torch

    # the children import the package this process imported
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(stoke_tpu_torch.__file__)))}
    env.pop(CHAOS_ENV, None)
    sup_dir = os.path.join(root, "sup")
    os.makedirs(sup_dir)
    sup = subprocess.Popen(
        [sys.executable, "-m", "stoke_tpu_torch.supervise",
         "--max-restarts", "2", "--base-s", "0.1", "--jitter-frac", "0",
         "--record", os.path.join(sup_dir, "restarts.jsonl"), "--",
         sys.executable, os.path.abspath(__file__), "--resilience-worker",
         sup_dir],
        env={**env, CHAOS_ENV: f"kill_at_step={RES_KILL_AT},"
             "kill_mode=sigkill"},
        stdout=open(os.path.join(root, "sup.out"), "w"),
        stderr=open(os.path.join(root, "sup.err"), "w"))
    bg.append(sup)
    part_dir = os.path.join(root, "partial")
    os.makedirs(part_dir)
    part = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resilience-worker",
         part_dir, "--partial"],
        env={**env, CHAOS_ENV: "kill_during_save=1"},
        stdout=subprocess.DEVNULL,
        stderr=open(os.path.join(root, "partial.err"), "w"))
    bg.append(part)
    elastic_root = os.path.join(root, "elastic")
    procs = start_elastic_world(elastic_root)
    bg.extend(procs)
    # 4. in-process preemption: eager, then inside replayed windows
    lives = []
    before = dict(ops.LAUNCHES)
    s = res_stoke(root, "pre", periodic="staged")
    got = {}
    for step in range(RES_EAGER - 1):
        got[step + 1] = float(s.train_step(batches[step], batches[step]))
    s.resilience.request_preemption("eager")
    try:
        s.train_step(batches[RES_EAGER - 1], batches[RES_EAGER - 1])
        raise AssertionError("life 1: no preemption")
    except PreemptedError as e:
        lives.append({"preempted_at": e.step, "tag": os.path.basename(
            e.tag_dir or ""), "launches": flash_delta(ops, before)})
    s.close_telemetry()
    del s
    before = dict(ops.LAUNCHES)
    s = res_stoke(root, "pre", init_seed=SEED + 1, periodic="staged")
    if not s.resume():
        raise AssertionError("life 2: resume() found no tag")
    life2_start = s.optimizer_steps
    first = life2_start + 1
    for i, v in enumerate(res_segment(s, batches, first,
                                      first + RES_SEGMENT - 1)):
        got[first + i] = v
    first += RES_SEGMENT
    timer = threading.Timer(0.02, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        res_segment(s, batches, first, first + RES_SEGMENT - 1)
        raise AssertionError("life 2: no preemption")
    except PreemptedError as e:
        lives.append({"start": life2_start, "preempted_at": e.step,
                      "signal": s.resilience.preempt_signal,
                      "tag": os.path.basename(e.tag_dir or ""),
                      "launches": flash_delta(ops, before)})
    timer.join()
    s.close_telemetry()
    del s
    before = dict(ops.LAUNCHES)
    s = res_stoke(root, "pre", init_seed=SEED + 2, periodic="staged")
    if not s.resume():
        raise AssertionError("life 3: resume() found no tag")
    life3_start = s.optimizer_steps
    rest = res_schedule(s, batches, life3_start)
    got.update(rest["losses"])
    s.wait_for_checkpoint()
    lives.append({"start": life3_start, "launches": flash_delta(ops, before),
                  "summary": s.resilience_summary})
    final_equal = masters_digest(s) == ref["digests"][RES_STEPS]
    s.close_telemetry()
    del s
    torch.cuda.empty_cache()
    section("preemption_lives")
    mismatched = {k: (v, ref["losses"][k]) for k, v in got.items()
                  if v != ref["losses"][k]}
    if mismatched or not final_equal:
        failures.append(f"preemption: losses {mismatched}, final masters "
                        f"equal {final_equal}")
    if [l["preempted_at"] for l in lives[:2]] != [RES_EAGER,
                                                  RES_EAGER + 2 * RES_SEGMENT]:
        failures.append(f"preemption steps {lives}")
    if lives[1]["signal"] != "SIGTERM":
        failures.append(f"life 2's notice: {lives[1]['signal']}")
    if not all(all(v > 0 for v in l["launches"].values()) for l in lives):
        failures.append(f"flash launches by life {lives}")
    # 5. corrupt_save=2
    s = res_stoke(root, "cor", layers=RES_SHORT_LAYERS,
                  chaos="corrupt_save=2")
    em = s.resilience.cfg.save_path
    for step in range(2):
        s.train_step(batches[step], batches[step])
        s.save(em, name="emergency")
    corrupted = list(s.resilience.chaos.corrupted)
    s.close_telemetry()
    del s
    r = res_stoke(root, "cor", layers=RES_SHORT_LAYERS, init_seed=SEED + 3)
    corrupt = {"resumed": r.resume(), "step": r.optimizer_steps,
               "corrupted": len(corrupted), **{
                   k: r.resilience_summary[k] for k in
                   ("quarantined_ckpts", "resumed_step", "lost_steps")}}
    r.close_telemetry()
    del r
    if corrupt != {"resumed": True, "step": 1, "corrupted": 1,
                   "quarantined_ckpts": 1, "resumed_step": 1,
                   "lost_steps": 1}:
        failures.append(f"corrupt_save: {corrupt}")
    section("corrupt_save")
    # 6. the background runs
    deadline = time.monotonic() + RES_TIMEOUT_S
    sup.wait(timeout=RES_TIMEOUT_S)
    with open(os.path.join(root, "sup.out")) as f:
        sup_out = f.read()
    with open(os.path.join(root, "sup.err")) as f:
        sup_err = f.read()
    def read_jsonl(path):
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f]

    sup_lives = read_jsonl(os.path.join(sup_dir, "lives.jsonl"))
    restarts = read_jsonl(os.path.join(sup_dir, "restarts.jsonl"))
    summary = [json.loads(ln)["supervise"] for ln in sup_out.splitlines()
               if '"supervise"' in ln]
    if not sup_lives or not summary:
        raise AssertionError(f"supervised run: rc {sup.returncode}, "
                             f"{restarts}: {sup_err[-3000:]}")
    summary = summary[-1]
    sup_losses = {int(k): v for l in sup_lives
                  for k, v in l["losses"].items()}
    sup_ok = (sup.returncode == 0 and summary["restarts"] == 1
              and [r["exit_code"] for r in restarts] == [-9, 0]
              and len(sup_lives) == 1 and sup_lives[0]["resumed"]
              and sup_lives[0]["start"] == RES_KILL_AT
              and all(sup_losses[k] == ref["losses"][k] for k in sup_losses)
              and sup_lives[0]["digests"][str(RES_WORKER_STEPS)]
              == ref["digests"][RES_WORKER_STEPS]
              and all(v > 0 for v in sup_lives[0]["launches"].values()))
    if not sup_ok:
        failures.append(f"supervised: rc {sup.returncode}, {restarts}, "
                        f"{sup_lives}, {sup_err[-2000:]}")
    section("supervised_wait")
    part.wait(timeout=max(1.0, deadline - time.monotonic()))
    with open(os.path.join(root, "partial.err")) as f:
        part_err = f.read()
    r = res_stoke(root, "partial-resume", layers=RES_SHORT_LAYERS)
    partial = {"exit_code": part.returncode,
               "resumed": r.resume(os.path.join(part_dir, "auto"),
                                   name="auto"),
               "quarantined": r.resilience_summary["quarantined_ckpts"]}
    r.close_telemetry()
    del r
    if partial != {"exit_code": -9, "resumed": False, "quarantined": 1}:
        failures.append(f"kill_during_save: {partial} {part_err[-1500:]}")
    section("partial_tag")
    join_procs(procs, "elastic CPU world", deadline)
    section("elastic_cpu_wait")
    elastic = elastic_resume(ops, elastic_root)
    section("elastic_resume")
    if failures:
        raise AssertionError("train_resilience: " + "; ".join(failures))
    return {
        "phase": "train_resilience",
        "model": "GPT-base (12 x 768, vocab 50257), bf16, dropout 0.1, "
                 "flash attention, AdamW(lr 3e-4, wd 1e-4), clip norm 1.0",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "off_vs_on": {
            "losses_equal": off["losses"] == ref["losses"],
            "dispatches": ref["dispatches"], "launches": ref["launches"],
            "timed": {"off": off["timed"], "on": ref["timed"]},
            "periodic_tags": auto_tags},
        "section_seconds": sections,
        "losses": ref["losses"],
        "staged_snapshot": snapshot, "save_stall": stall,
        "preemption": {"lives": lives, "losses_equal": not mismatched,
                       "final_masters_equal": final_equal},
        "supervised": {"summary": summary, "restarts": restarts,
                       "lives": [{k: l[k] for k in
                                  ("attempt", "start", "seconds",
                                   "launches")} for l in sup_lives],
                       "bit_equal": sup_ok},
        "corrupt_save": corrupt, "kill_during_save": partial,
        "elastic": elastic,
        "launches": {n: sum(l["launches"][n] for l in lives)
                     for n in FLASH},
    }


#: the offload runs: steps eager, then train_steps windows (the first
#: window of the call eager and captured, the next replayed)
OFFLOAD_EAGER, OFFLOAD_WINDOWS = 5, 2


def offload_run(ops, tier: str, batches, root: str) -> dict:
    """GPT-base bf16 with one optimizer-state tier: OFFLOAD_EAGER eager
    steps then ``train_steps`` over OFFLOAD_WINDOWS windows; the peak
    device bytes after the first step (the host tier's first step makes
    its state on the card), the eager step ms p50 and the replayed
    window's ms; where the state lives between steps."""
    from stoke_tpu_torch.configs import (OffloadDiskConfig,
                                         OffloadOptimizerConfig,
                                         OffloadParamsConfig)

    configs = {"none": [], "optimizer": [OffloadOptimizerConfig()],
               "disk": [OffloadDiskConfig(path=root)], "fsdp": [],
               "params": [OffloadParamsConfig()]}[tier]
    flags = (dict(distributed="dp", fsdp=True)
             if tier in ("fsdp", "params") else {})
    torch.cuda.empty_cache()
    before = dict(ops.LAUNCHES)
    s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, configs=configs,
                  **flags)
    losses, ms = [], []
    for i in range(OFFLOAD_EAGER):
        b = batches[i]
        ms.append(timed_ms(lambda: losses.append(float(s.train_step(b, b)))))
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    first = OFFLOAD_EAGER
    seg = batches[first:first + 1]
    window_ms = [timed_ms(lambda: losses.extend(
        float(v) for v in s.train_steps(seg, seg).reshape(-1)))]
    seg = batches[first + 1:first + OFFLOAD_WINDOWS]
    window_ms.append(timed_ms(lambda: losses.extend(
        float(v) for v in s.train_steps(seg, seg).reshape(-1))))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    # between steps: what stays on the card (the batches and the model's
    # own buffers included)
    between = torch.cuda.memory_allocated()
    state = [v for p in s.model_access.parameters()
             for k, v in s.optimizer.state[p].items()
             if torch.is_tensor(v) and v.dim()]
    out = {"tier": tier, "losses": losses, "digest": masters_digest(s),
           "peak_bytes": peak, "between_steps_bytes": between,
           "eager_step_ms": ms,
           "eager_step_ms_p50": float(np.median(ms[1:])),
           "window_ms": window_ms,
           "launches": flash_delta(ops, before),
           "state_tensors": len(state),
           "state_bytes": int(sum(v.numel() * v.element_size()
                                  for v in state))}
    if tier == "optimizer":
        hs = s._engine.host_state
        out.update(pinned=all(v.is_pinned() and v.device.type == "cpu"
                              for v in state),
                   groups=len(hs.groups), buffer_bytes=hs.buffer_bytes,
                   windows_captured=len(s._engine._windows))
    if tier == "params":
        hosts = s._ladder.host_slices
        out.update(pinned=bool(hosts) and all(
            h.is_pinned() for h in hosts),
            slices_bytes=int(sum(h.numel() * h.element_size()
                                 for h in hosts)),
            device_slices_freed=all(
                b.own.untyped_storage().nbytes() == 0
                for b in s._ladder._freed),
            windows_captured=len(s._engine._windows))
    if tier == "disk":
        store = s._engine.disk_store
        out.update(spilled_files=len(store.files()),
                   files_exist=all(os.path.exists(f)
                                   for f in store.files()),
                   freed=all(v.untyped_storage().size() == 0
                             for v in state),
                   windows_captured=len(s._engine._windows))
    s.close_telemetry()
    del s
    return out


def offload(ops) -> dict:
    """The optimizer state's tiers on GPT-base bf16 (B=8, L=1024, flash
    attention, AdamW, clip 1.0): no offload, ``OffloadOptimizerConfig``
    (pinned host memory, streamed through the card in leaf groups; the
    window captured) and ``OffloadDiskConfig`` (files; the window runs
    uncaptured), each :func:`offload_run`: losses and masters bit for bit
    against no offload, the state pinned or spilled between steps, the
    peak device bytes and step ms; and fsdp in a one-process NCCL group
    without and with ``OffloadParamsConfig`` (the slices pinned between
    steps, the window captured), bit for bit."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke-offload-")
    try:
        batches = window_batches(OFFLOAD_EAGER + OFFLOAD_WINDOWS)
        runs = {t: offload_run(ops, t, batches, root)
                for t in ("none", "optimizer", "disk", "fsdp", "params")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    failures = []
    for t, against in (("optimizer", "none"), ("disk", "none"),
                       ("params", "fsdp")):
        r, base = runs[t], runs[against]
        if r["losses"] != base["losses"] or r["digest"] != base["digest"]:
            failures.append(f"{t}: losses {r['losses']} vs "
                            f"{base['losses']}, masters equal "
                            f"{r['digest'] == base['digest']}")
        if r["launches"] != base["launches"]:
            failures.append(f"{t}: launches {r['launches']}")
    opt, disk, par = runs["optimizer"], runs["disk"], runs["params"]
    for name, r in (("optimizer", opt), ("params", par)):
        if not r["pinned"] or r["windows_captured"] != 1:
            failures.append(f"{name} tier: pinned {r['pinned']}, windows "
                            f"captured {r['windows_captured']}")
    if not par["device_slices_freed"]:
        failures.append("params tier: the slices' device buffers hold "
                        "memory between steps")
    if not (disk["files_exist"] and disk["freed"] and disk["spilled_files"]
            and disk["windows_captured"] == 0):
        failures.append(f"disk tier: {disk}")
    if failures:
        raise AssertionError("offload: " + "; ".join(failures))
    pairs = (("optimizer", "none"), ("disk", "none"), ("params", "fsdp"))
    return {"phase": "offload", "runs": runs,
            "peak_drop_bytes": {
                t: runs[b]["peak_bytes"] - runs[t]["peak_bytes"]
                for t, b in pairs},
            "between_steps_drop_bytes": {
                t: runs[b]["between_steps_bytes"]
                - runs[t]["between_steps_bytes"] for t, b in pairs},
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in FLASH},
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------- #
# phase 21: rematerialization and GPT's untied head
# --------------------------------------------------------------------------- #


#: the compared schedule (eager steps, then train_steps of REMAT_SEGMENT
#: windows to REMAT_STEPS), then REMAT_TIMED_SEGMENTS more timed segments
REMAT_EAGER, REMAT_STEPS, REMAT_SEGMENT = 6, 12, 3
REMAT_TIMED_SEGMENTS = 5
REMAT_DROPOUT = 0.1
ENGINE_POLICIES = ("nothing_saveable", "dots_saveable",
                   "dots_with_no_batch_dims_saveable", "everything_saveable")


def remat_stoke(remat: bool = False, policy: str = None, tie: bool = True,
                dropout: float = REMAT_DROPOUT):
    """GPT-base bf16 (flash, dropout on the embeddings and residuals) with
    per-block remat (``remat``), an engine policy
    (``ActivationCheckpointingConfig``) or the untied head."""
    from stoke_tpu_torch.configs import ActivationCheckpointingConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.ops import make_flash_attention

    model = GPT(vocab_size=VOCAB, size_name="base", max_len=1024,
                dropout_rate=dropout,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True, tie_embeddings=tie, remat=remat,
                device="cuda")
    for block in model.layers:
        block.attention.prob_dropout.rate = 0.0
    model.init_weights(SEED)
    configs = ([ActivationCheckpointingConfig(policy=policy)]
               if policy is not None else None)
    return stoke_for(model, "bf16", TRAIN_BATCH, seed=SEED, configs=configs)


def remat_run(ops, batches, remat: bool) -> dict:
    """The compared schedule and the timed segments of one run: losses by
    step, the masters' digest at REMAT_STEPS, eager step ms, replayed step
    ms (a segment's ms over its windows), the peak device bytes of the
    whole run and the flash launches."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(ops.LAUNCHES)
    s = remat_stoke(remat=remat)
    losses, eager_ms = eager_steps(s, [batches[i]
                                       for i in range(REMAT_EAGER)])
    seg_ms = []
    step = REMAT_EAGER
    stop = REMAT_STEPS + REMAT_TIMED_SEGMENTS * REMAT_SEGMENT
    digest = None
    while step < stop:
        seg = batches[step:step + REMAT_SEGMENT]
        out = []
        seg_ms.append(timed_ms(lambda: out.append(s.train_steps(seg, seg))))
        losses += [float(v) for v in out[0].reshape(-1).tolist()]
        step += REMAT_SEGMENT
        if step == REMAT_STEPS:
            digest = masters_digest(s)
    peak = torch.cuda.max_memory_allocated()
    launches = flash_delta(ops, before)
    replayed = [m / REMAT_SEGMENT for m in
                seg_ms[(REMAT_STEPS - REMAT_EAGER) // REMAT_SEGMENT:]]
    out = {"losses": losses, "digest": digest, "final": masters_digest(s),
           "steps": s.optimizer_steps, "launches": launches,
           "eager_ms": eager_ms,
           "eager_ms_p50": float(np.median(eager_ms[WARMUP_STEPS:])),
           "replayed_ms": replayed,
           "replayed_ms_p50": float(np.median(replayed)),
           "peak_bytes": peak,
           "windows_captured": len(s._engine._windows)}
    del s
    torch.cuda.empty_cache()
    return out


def remat_policy_run(ops, batches, policy: str = None) -> dict:
    """One eager step, then ``train_steps`` of two windows (the first
    eager and captured, the second replayed) under an engine policy."""
    before = dict(ops.LAUNCHES)
    s = remat_stoke(policy=policy)
    losses = [float(s.train_step(batches[0], batches[0]))]
    losses += [float(v) for v in
               s.train_steps(batches[1:3], batches[1:3]).reshape(-1).tolist()]
    out = {"losses": losses, "digest": masters_digest(s),
           "launches": flash_delta(ops, before),
           "windows_captured": len(s._engine._windows)}
    del s
    torch.cuda.empty_cache()
    return out


def train_remat(ops) -> dict:
    """GPT-base bf16 (B=8, L=1024, dropout 0.1, flash) without and with
    ``remat=True`` (each block recomputed in backward, its dropout masks
    replayed): 6 eager steps and ``train_steps`` of 3 windows to step 12,
    losses and masters bit for bit; then three timed segments of 3
    replays each. Eager and replayed step ms p50 and the peak device bytes
    of each run; the flash forward kernel launched twice as often as each
    backward kernel under remat. One eager step and a two-window
    ``train_steps`` under each engine policy
    (``ActivationCheckpointingConfig``, the windows captured under the
    selective policies' dispatch modes), bit for bit against the same
    without; GPT-base with the untied head trains (its loss falls over
    three steps on one batch)."""
    t0 = time.perf_counter()
    n = REMAT_STEPS + REMAT_TIMED_SEGMENTS * REMAT_SEGMENT
    batches = window_batches(n)
    failures = []
    runs = {name: remat_run(ops, batches, remat)
            for name, remat in (("plain", False), ("remat", True))}
    plain, rem = runs["plain"], runs["remat"]
    compared = REMAT_STEPS
    if plain["losses"][:compared] != rem["losses"][:compared] or \
            plain["digest"] != rem["digest"]:
        failures.append(f"remat vs plain: losses {rem['losses'][:compared]} "
                        f"vs {plain['losses'][:compared]}, masters equal "
                        f"{plain['digest'] == rem['digest']}")
    if plain["losses"] != rem["losses"] or plain["final"] != rem["final"]:
        failures.append("remat vs plain: the timed segments differ")
    steps = plain["steps"]
    per_step = N_LAYERS * steps
    if plain["launches"] != dict.fromkeys(FLASH, per_step):
        failures.append(f"plain launches {plain['launches']}")
    if rem["launches"] != {"flash_fwd": 2 * per_step,
                           "flash_bwd_dq": per_step,
                           "flash_bwd_dkv": per_step}:
        failures.append(f"remat launches {rem['launches']}, expected the "
                        f"forward twice each backward kernel's {per_step}")
    if not (plain["windows_captured"] and rem["windows_captured"]):
        failures.append("a window was not captured")
    if not rem["peak_bytes"] < plain["peak_bytes"]:
        failures.append(f"remat's peak {rem['peak_bytes']} is not below the "
                        f"plain run's {plain['peak_bytes']}")
    policies = {"none": remat_policy_run(ops, batches)}
    for policy in ENGINE_POLICIES:
        policies[policy] = remat_policy_run(ops, batches, policy)
    ref = policies["none"]
    for policy in ENGINE_POLICIES:
        r = policies[policy]
        if r["losses"] != ref["losses"] or r["digest"] != ref["digest"]:
            failures.append(f"policy {policy}: losses {r['losses']} vs "
                            f"{ref['losses']}")
        if r["windows_captured"] != 1:
            failures.append(f"policy {policy}: windows captured "
                            f"{r['windows_captured']}")
        fwd = (1 if policy == "everything_saveable" else 2) * 3 * N_LAYERS
        if r["launches"]["flash_fwd"] != fwd:
            failures.append(f"policy {policy}: launches {r['launches']}")
    s = remat_stoke(tie=False, dropout=0.0)
    untied = [float(s.train_step(batches[0], batches[0])) for _ in range(3)]
    if not (untied[-1] < untied[0]) or not all(np.isfinite(untied)):
        failures.append(f"untied head: losses {untied}")
    untied_head = tuple(s.model_access.lm_head.weight.shape)
    del s
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("train_remat: " + "; ".join(failures))
    launches = {n_: plain["launches"][n_] + rem["launches"][n_]
                + sum(r["launches"][n_] for r in policies.values())
                for n_ in FLASH}
    return {
        "phase": "train_remat",
        "model": "GPT-base (12 x 768, 12 heads, ff 3072, vocab 50257), "
                 "bf16 over fp32 masters, B=8, L=1024, dropout 0.1, flash, "
                 "AdamW, clip 1.0",
        "losses_equal": True, "masters_equal": True, "steps": steps,
        "plain": {k: plain[k] for k in ("eager_ms_p50", "replayed_ms_p50",
                                        "peak_bytes", "launches",
                                        "eager_ms", "replayed_ms")},
        "remat": {k: rem[k] for k in ("eager_ms_p50", "replayed_ms_p50",
                                      "peak_bytes", "launches",
                                      "eager_ms", "replayed_ms")},
        "peak_drop_bytes": plain["peak_bytes"] - rem["peak_bytes"],
        "eager_ms_added": rem["eager_ms_p50"] - plain["eager_ms_p50"],
        "replayed_ms_added": rem["replayed_ms_p50"]
        - plain["replayed_ms_p50"],
        "losses": plain["losses"],
        "policies": {p: {"losses_equal": True,
                         "launches": policies[p]["launches"],
                         "windows_captured":
                             policies[p]["windows_captured"]}
                     for p in ENGINE_POLICIES},
        "untied": {"losses": untied, "lm_head": untied_head},
        "launches": launches,
        "seconds": time.perf_counter() - t0,
    }


# --------------------------------------------------------------------------- #
# phase 22: the observatories (attribution, memory, numerics; serve SLO and
# cost cards)
# --------------------------------------------------------------------------- #


OBS_EAGER, OBS_TIMED = 6, 5
OBS_PEAKS = dict(peak_tflops=989.0, peak_hbm_gbps=3350.0)
#: the ledger against the allocator's bytes between steps (the tensors the
#: run holds are the ledger's; what else is allocated is the allocator's)
OBS_LEDGER_RTOL = 0.01
#: the numerics rows against the host's fp64 recompute
OBS_NUMERICS_RTOL = 1e-5
OBS_SLO = dict(slo_ttft_target_s=2.0, slo_tpot_target_s=0.05)


def obs_run(ops, batches, observe: bool, root: str) -> dict:
    """GPT-base bf16 with or without ``TelemetryConfig``,
    ``AttributionConfig``, ``MemoryConfig`` and ``NumericsConfig``:
    OBS_EAGER eager ``train_step``s, ``train_steps`` of two windows (the
    first eager and captured), then one more window replayed with the
    parameters read before and after it. With the observatories: the
    ledger against the allocator between steps, the pre-flight's
    prediction, the numerics rows of the replayed window against the
    host's recompute, the fused card's FLOPs against
    ``estimate_step_flops``, every logged ``mfu`` and ``hbm_bw_util``."""
    from stoke_tpu_torch.configs import (
        AttributionConfig,
        MemoryConfig,
        NumericsConfig,
        TelemetryConfig,
    )

    configs = None
    if observe:
        configs = [TelemetryConfig(output_dir=root, log_every_n_steps=1,
                                   prometheus=False, tensorboard=False),
                   AttributionConfig(**OBS_PEAKS), MemoryConfig(),
                   NumericsConfig()]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(ops.LAUNCHES)
    s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, seed=SEED,
                  configs=configs)
    out = {}
    if observe:
        out["preflight"] = s.memory_summary["preflights"]["build"]
    losses, ms = eager_steps(s, [batches[i] for i in range(OBS_EAGER)])
    if observe:
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - base
        resident = s.memory.resident_bytes()
        out["ledger"] = {"resident_bytes": resident,
                         "allocated_bytes": allocated,
                         "gap_bytes": allocated - resident,
                         "components": s.memory.ledger()}
    seg = batches[OBS_EAGER:OBS_EAGER + 2]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    replay_ms = []
    for i in range(OBS_TIMED):
        b = batches[OBS_EAGER + 2 + i:OBS_EAGER + 3 + i]
        replay_ms.append(timed_ms(lambda: losses.extend(
            float(v) for v in s.train_steps(b, b).reshape(-1))))
    params = [p for p in s.model_access.parameters()]
    old = [p.detach().double().cpu() for p in params]
    last = batches[-1:]
    losses += [float(v) for v in s.train_steps(last, last).reshape(-1)]
    out.update(losses=losses, digest=masters_digest(s),
               launches=flash_delta(ops, before), eager_ms=ms,
               eager_ms_p50=float(np.median(ms[WARMUP_STEPS:])),
               replayed_ms=replay_ms,
               replayed_ms_p50=float(np.median(replay_ms)),
               dispatches=s.dispatch_count,
               windows_captured=len(s._engine._windows))
    if not observe:
        # the memory observatory resets the peak statistic at each
        # program's first run: the observed run's programs carry theirs
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if observe:
        new = [p.detach().double().cpu() for p in params]
        row = s._engine.numerics_row.double().cpu().numpy()
        worst = 0.0
        for g, group in enumerate(s.numerics.groups):
            p_sq = sum(float(new[i].square().sum())
                       for i in group.param_indices)
            u_sq = sum(float((new[i] - old[i]).square().sum())
                       for i in group.param_indices)
            worst = max(worst, abs(row[g, 3] - p_sq) / p_sq,
                        abs(row[g, 4] - u_sq) / max(u_sq, 1e-30))
        out["numerics_rel_err"] = worst
        out["numerics_groups"] = [g.name for g in s.numerics.groups]
        cards = {k[0]: c for k, c in s.attribution.cost_cards.cards.items()}
        out["cards"] = {k: c.to_dict() for k, c in cards.items()}
        out["memory"] = s.memory_summary
        out["goodput"] = s.goodput
        s.close_telemetry()
        with open(os.path.join(root, "steps.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        out["mfu"] = [r["mfu"] for r in recs]
        out["hbm_bw_util"] = [r["hbm_bw_util"] for r in recs]
        out["estimate_step_flops"] = s.estimate_step_flops(batches[0],
                                                           batches[0])
    del s
    torch.cuda.empty_cache()
    return out


def obs_drive(engine, prompts, slo=None) -> tuple:
    """:func:`drive`'s three waves, each request with ``slo``."""
    kw = {} if slo is None else {"slo": slo}
    t0 = time.perf_counter()
    rids = [engine.submit(p, **kw) for p in prompts[:8]]
    for _ in range(4):
        engine.step()
    rids += [engine.submit(p, **kw) for p in prompts[8:12]]
    for _ in range(8):
        engine.step()
    rids += [engine.submit(p, **kw) for p in prompts[12:]]
    engine.run()
    wall = time.perf_counter() - t0
    return [list(engine.result(r).tokens) for r in rids], wall


def obs_serve(ops) -> dict:
    """The serve trace (GPT-base fp32, the ``serve`` phase's prompts) on
    the decode kernel and the speculative trace on the verify kernel,
    each plain and with ``ServeConfig(cost_cards=True)``, the SLO targets
    (every request tagged), the run's peaks and a ``MemoryConfig``, each
    engine driven twice: the first drive counts each program's card at
    its first dispatch, the second runs on the cards (TTFT and TPOT p50 of
    both, beside the plain engine's drives). Streams equal, MFU and
    bandwidth utilization in (0, 1], the SLO tracker's counts the two
    drives' requests."""
    import dataclasses

    from stoke_tpu_torch.configs import (
        AttributionConfig,
        MemoryConfig,
        ServeConfig,
    )
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine
    from stoke_tpu_torch.serving.slo import RequestSLO

    model = GPT(size_name="base", device="cuda")
    model.init_weights(SEED)
    weights = model.state_dict()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, model.vocab_size, size=int(n))
               for n in rng.integers(16, 401, size=16)]
    spec_prompts = requote_prompts(np.random.default_rng(SEED + 1),
                                   model.vocab_size)
    traces = {
        "decode": (ServeConfig(attention="flash", decode_kernel="pallas",
                               **SERVE), prompts),
        "verify": (ServeConfig(**SPEC, speculative_k=SPEC_K), spec_prompts),
    }
    out, failures = {}, []
    for name, (cfg, ps) in traces.items():
        # warm the libraries outside the measured drives
        ServingEngine(model, weights, cfg).generate([ps[0][:16]], 2)
        ops.reset_launches()
        plain = ServingEngine(model, weights, cfg)
        plain_streams, _ = obs_drive(plain, ps)
        plain_cold = plain.metrics.latency_percentiles()
        plain.metrics.reset_latency_reservoirs()
        obs_drive(plain, ps)
        obs_cfg = dataclasses.replace(cfg, cost_cards=True, **OBS_SLO)
        before = dict(ops.LAUNCHES)
        engine = ServingEngine(model, weights, obs_cfg,
                               attribution=AttributionConfig(**OBS_PEAKS),
                               memory=MemoryConfig())
        streams, wall = obs_drive(engine, ps, RequestSLO())
        cold = engine.metrics.latency_percentiles()
        engine.metrics.reset_latency_reservoirs()
        warm_streams, _ = obs_drive(engine, ps, RequestSLO())
        launches = {k: ops.LAUNCHES[k] - before[k]
                    for k in ("flash_fwd", "paged_decode", "paged_verify")}
        s, ps_ = engine.summary(), plain.summary()
        cost, slo = s["cost"], s["slo"]
        if streams != plain_streams or warm_streams != plain_streams:
            failures.append(f"{name}: the streams differ from the plain "
                            f"engine's")
        for key in ("mfu", "hbm_bw_util"):
            if not (cost[key] is not None and 0 < cost[key] <= 1):
                failures.append(f"{name}: {key} {cost[key]}")
        if not (slo["requests"] == slo["finished"] == 2 * len(ps)):
            failures.append(f"{name}: SLO counts {slo['requests']} / "
                            f"{slo['finished']} of 2 x {len(ps)}")
        kernel = "paged_verify" if name == "verify" else "paged_decode"
        if not launches[kernel]:
            failures.append(f"{name}: {kernel} never launched")
        out[name] = {
            "streams_equal": True,
            "tpot_p50_s": s["tpot_p50_s"], "plain_tpot_p50_s":
                ps_["tpot_p50_s"], "ttft_p50_s": s["ttft_p50_s"],
            "plain_ttft_p50_s": ps_["ttft_p50_s"],
            "cold_tpot_p50_s": cold["tpot_p50_s"],
            "plain_cold_tpot_p50_s": plain_cold["tpot_p50_s"],
            "cold_ttft_p50_s": cold["ttft_p50_s"],
            "plain_cold_ttft_p50_s": plain_cold["ttft_p50_s"],
            "cold_wall_s": wall,
            "cost": {k: cost[k] for k in (
                "mfu", "hbm_bw_util", "flops_per_token",
                "attainable_tpot_s", "achieved_tpot_s", "decode_bound",
                "decode_intensity", "verify_intensity", "flops_total",
                "bytes_total")},
            "cards": cost["cards"],
            "slo": {k: slo[k] for k in ("requests", "finished", "attained",
                                        "violated", "ttft_attainment",
                                        "tpot_attainment")},
            "memory": s["memory"]["components"],
            "mem_headroom_bytes": engine.event_fields()[
                "serve/mem_headroom_bytes"],
            "launches": launches,
        }
        del engine, plain
        torch.cuda.empty_cache()
    return out, failures


def observatories(ops) -> dict:
    """GPT-base bf16 with the training observatories against the same run
    without: losses, parameters and dispatches bit for bit; the ledger
    within OBS_LEDGER_RTOL of the allocator's bytes between steps; the
    fused card's FLOPs equal to ``estimate_step_flops``; every logged
    ``mfu`` and ``hbm_bw_util`` in (0, 1]; the numerics rows of a replayed
    window equal to the host's recompute. Then the serve and speculative
    traces with cost cards and SLO targets (:func:`obs_serve`)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke-obs-")
    try:
        batches = window_batches(OBS_EAGER + 3 + OBS_TIMED)
        plain = obs_run(ops, batches, False, root)
        obs = obs_run(ops, batches, True, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    for key in ("losses", "digest", "launches", "dispatches"):
        if plain[key] != obs[key]:
            failures.append(f"{key}: {obs[key]} vs {plain[key]}")
    led = obs["ledger"]
    if abs(led["gap_bytes"]) > OBS_LEDGER_RTOL * led["resident_bytes"]:
        failures.append(f"ledger {led['resident_bytes']} against "
                        f"{led['allocated_bytes']} allocated")
    fused = obs["cards"].get("fused")
    if fused is None or fused["flops"] != obs["estimate_step_flops"]:
        failures.append(f"fused card {fused} against estimate_step_flops "
                        f"{obs['estimate_step_flops']}")
    for key in ("mfu", "hbm_bw_util"):
        vals = obs[key][1:]
        if not vals or not all(v is not None and 0 < v <= 1 for v in vals):
            failures.append(f"{key}: {obs[key]}")
    if not obs["numerics_rel_err"] <= OBS_NUMERICS_RTOL:
        failures.append(f"numerics rows {obs['numerics_rel_err']} off the "
                        f"host's recompute")
    if obs["windows_captured"] != 1:
        failures.append(f"windows captured {obs['windows_captured']}")
    served, serve_failures = obs_serve(ops)
    failures += serve_failures
    if failures:
        raise AssertionError("observatories: " + "; ".join(failures))
    launches = {**{k: obs["launches"][k] for k in FLASH},
                "serve_flash_fwd": sum(v["launches"]["flash_fwd"]
                                       for v in served.values()),
                "paged_decode": served["decode"]["launches"]["paged_decode"],
                "paged_verify": served["verify"]["launches"]["paged_verify"]}
    return {
        "phase": "observatories",
        "model": "GPT-base bf16, B=8, L=1024, flash, AdamW, clip 1.0; "
                 "serving GPT-base fp32 (the serve and serve_spec traces)",
        "bit_for_bit": True,
        "eager_ms_p50": {"plain": plain["eager_ms_p50"],
                         "observed": obs["eager_ms_p50"]},
        "replayed_ms_p50": {"plain": plain["replayed_ms_p50"],
                            "observed": obs["replayed_ms_p50"]},
        "replayed_ms": {"plain": plain["replayed_ms"],
                        "observed": obs["replayed_ms"]},
        "peak_bytes_plain": plain["peak_bytes"],
        "preflight": obs["preflight"],
        "predicted_peak_bytes": obs["memory"]["predicted_peak_bytes"],
        "ledger": led, "memory": obs["memory"],
        "cards": obs["cards"],
        "estimate_step_flops": obs["estimate_step_flops"],
        "mfu": obs["mfu"], "hbm_bw_util": obs["hbm_bw_util"],
        "goodput": obs["goodput"],
        "numerics_rel_err": obs["numerics_rel_err"],
        "numerics_groups": obs["numerics_groups"],
        "serve": served,
        "launches": launches,
        "seconds": time.perf_counter() - t0,
    }


FLEET_EAGER = 8          # eager train_steps (the /profile capture rides them)
FLEET_PROFILE_AT = 2     # the eager step before which /profile is scraped
FLEET_TIMED = 6          # single-window replays after a 4-window segment
FLEET_WINDOW = 2         # FleetConfig.window_steps
FLEET_PROFILE_S = 0.25   # /profile?seconds=
ENDPOINTS = ("/metrics", "/healthz", "/statusz", "/requests", "/trace")
SCRAPE_PERIOD_S = 0.05


def http_get(url: str, method: str = "GET", timeout: float = 90.0) -> tuple:
    """(status, body bytes) of one request to the loopback ops plane; an
    HTTP error gives its status."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method,
                                 data=None if method == "GET" else b"{}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def endpoint_miss(path: str, status: int, body: bytes) -> str:
    """'' when an endpoint answered 200 in its shape, else what was
    wrong."""
    from stoke_tpu_torch.telemetry.opsplane import STATUSZ_FIELDS

    if status != 200:
        return f"{path}: status {status}"
    if path == "/metrics":
        ok = b"stoke_fleet_windows_total" in body
    else:
        obj = json.loads(body)
        if path == "/healthz":
            ok = obj.get("ok") is True
        elif path == "/statusz":
            ok = tuple(obj) == STATUSZ_FIELDS
        elif path == "/requests":
            ok = set(obj) == {"requests", "truncated"}
        else:  # the span ring: metadata first, spans once steps ran
            ok = bool(obj) and all("ph" in e and "name" in e for e in obj)
    return "" if ok else f"{path}: {body[:120]!r}"


class Scraper:
    """A thread reading ``paths`` of a plane in turn until the block
    ends: each path's answers, the first misses (a request that raised is
    one), and the states of the non-empty /requests tables. ``misses``
    also names a thread that ended before the block did and answer counts
    that differ between paths (every round reads every path)."""

    def __init__(self, base: str, paths=ENDPOINTS):
        import threading

        self.base, self.paths = base, paths
        self.counts = {p: 0 for p in paths}
        self.misses, self.states = [], set()
        self.tables_with_rows = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _miss(self, miss: str) -> None:
        if len(self.misses) < 5:
            self.misses.append(miss)

    def _run(self):
        # a round of every path each SCRAPE_PERIOD_S (far faster than a
        # Prometheus scrape interval)
        while not self._stop.wait(SCRAPE_PERIOD_S):
            for p in self.paths:
                self.counts[p] += 1
                try:
                    status, body = http_get(self.base + p)
                    miss = endpoint_miss(p, status, body)
                    if p == "/requests" and not miss:
                        rows = json.loads(body)["requests"]
                        self.tables_with_rows += bool(rows)
                        self.states.update(r["state"] for r in rows)
                except Exception as e:   # a dead plane, a malformed body
                    miss = f"{p}: {type(e).__name__}: {e}"
                if miss:
                    self._miss(miss)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if not self._thread.is_alive():
            self._miss("the scraper thread ended before its block")
        self._stop.set()
        self._thread.join(120)
        if self._thread.is_alive():
            self._miss("the scraper thread outlived its block by 120 s")
        if len(set(self.counts.values())) > 1:
            self._miss(f"answer counts differ: {self.counts}")


def fleet_configs(root: str, tag: str, fleet: bool) -> list:
    """Telemetry (every step logged), tracing, health, attribution (no
    auto-capture: the one capture of the budget is the plane's), the
    profiler's trace directory and the serve trace's ``ServeConfig``;
    with ``fleet``, ``FleetConfig(window_steps=2)`` and
    ``OpsPlaneConfig(port=0)`` too."""
    from stoke_tpu_torch.configs import (
        AttributionConfig,
        FleetConfig,
        HealthConfig,
        OpsPlaneConfig,
        ProfilerConfig,
        ServeConfig,
        TelemetryConfig,
        TraceConfig,
    )

    d = os.path.join(root, tag)
    cfgs = [TelemetryConfig(output_dir=d, log_every_n_steps=1,
                            prometheus=False, tensorboard=False),
            TraceConfig(output_dir=d, export_on_close=False),
            HealthConfig(dump_signals=False),
            AttributionConfig(**OBS_PEAKS, auto_capture=False,
                              max_captures=1),
            ProfilerConfig(trace_dir=os.path.join(d, "prof")),
            ServeConfig(attention="flash", decode_kernel="pallas", **SERVE)]
    if fleet:
        cfgs += [FleetConfig(window_steps=FLEET_WINDOW),
                 OpsPlaneConfig(port=0)]
    return cfgs


def profile_scrapes(base: str, s, out: dict) -> None:
    """/profile while the run trains: one capture (200), another while it
    is in flight (409), one past the budget of one (429), and a POST
    (405)."""
    import threading

    def first():
        status, body = http_get(f"{base}/profile?seconds={FLEET_PROFILE_S}")
        out["first"] = (status, json.loads(body))

    t = threading.Thread(target=first, daemon=True)
    t.start()
    while not s.attribution._capturing and t.is_alive():
        time.sleep(0.001)
    out["in_flight"] = http_get(f"{base}/profile?seconds=0.1")[0]
    t.join(120)
    out["past_budget"] = http_get(f"{base}/profile?seconds=0.1")[0]
    out["post"] = http_get(f"{base}/statusz", method="POST")[0]


def fleet_run(ops, batches, fleet: bool, root: str) -> dict:
    """GPT-base bf16 with the run's observers, with or without the fleet
    and the plane: FLEET_EAGER eager ``train_step``s, ``train_steps`` of 4
    windows and FLEET_TIMED single-window replays; with the plane, a
    thread scrapes every endpoint throughout and another scrapes
    /profile from eager step FLEET_PROFILE_AT on (the capture runs on the
    plane's thread while the training thread steps). The eager p50 leaves
    out the warm-up and the steps that ran under the capture."""
    import contextlib
    import threading

    before = dict(ops.LAUNCHES)
    s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH, seed=SEED,
                  configs=fleet_configs(root, f"fleet{fleet}", fleet))
    base = f"http://127.0.0.1:{s.opsplane.port}" if fleet else None
    scraper = Scraper(base) if fleet else contextlib.nullcontext()
    prof = {}
    if fleet:
        prof_thread = threading.Thread(
            target=profile_scrapes, args=(base, s, prof), daemon=True)
    with scraper:
        losses, ms, profiled = [], [], []
        for i in range(FLEET_EAGER):
            if fleet and i == FLEET_PROFILE_AT:
                # the capture runs over the next steps
                prof_thread.start()
                deadline = time.monotonic() + 60
                while (not s.attribution._capturing and prof_thread.is_alive()
                       and time.monotonic() < deadline):
                    time.sleep(0.001)
            # a step with a capture in flight at its start or end is
            # profiled
            was = fleet and s.attribution._capturing
            ms.append(timed_ms(lambda: losses.append(
                float(s.train_step(batches[i], batches[i])))))
            profiled.append(was or (fleet and s.attribution._capturing))
        seg = batches[FLEET_EAGER:FLEET_EAGER + 4]
        losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
        replay_ms = []
        for i in range(FLEET_TIMED):
            b = batches[FLEET_EAGER + 4 + i:FLEET_EAGER + 5 + i]
            replay_ms.append(timed_ms(lambda: losses.extend(
                float(v) for v in s.train_steps(b, b).reshape(-1))))
        if fleet:
            prof_thread.join(180)
    unprofiled = [m for i, m in enumerate(ms)
                  if i >= WARMUP_STEPS and not profiled[i]]
    out = {"stoke": s, "losses": losses, "eager_ms": ms,
           "profiled_steps": [i + 1 for i, p in enumerate(profiled) if p],
           "eager_ms_p50": float(np.median(unprofiled)),
           "replayed_ms": replay_ms,
           "replayed_ms_p50": float(np.median(replay_ms)),
           "digest": masters_digest(s), "launches": flash_delta(ops, before),
           "dispatches": s.dispatch_count,
           "windows_captured": len(s._engine._windows)}
    if fleet:
        out.update(scrapes=scraper.counts, scrape_misses=scraper.misses,
                   profile=prof, profile_alive=prof_thread.is_alive(),
                   fleet_summary=s.fleet_summary)
    return out


def fleet_serve(ops, s, scrape: bool) -> dict:
    """``Stoke.serve()``'s engine (attached to the run's plane, if any)
    on the serve phase's prompts, /requests and /statusz scraped while it
    drives when ``scrape``: the streams, TPOT p50 and the decode kernel's
    launches."""
    import contextlib

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, VOCAB, size=int(n))
               for n in rng.integers(16, 401, size=16)]
    engine = s.serve()
    engine.generate([prompts[0][:16]], 2)   # warm the libraries
    engine.metrics.reset_latency_reservoirs()
    before = ops.LAUNCHES["paged_decode"]
    scraper = (Scraper(f"http://127.0.0.1:{s.opsplane.port}",
                       ("/requests", "/statusz")) if scrape
               else contextlib.nullcontext())
    with scraper:
        streams, wall = drive(engine, prompts)
    out = {"streams": streams, "wall_s": wall,
           "tpot_p50_s": engine.summary()["tpot_p50_s"],
           "paged_decode": ops.LAUNCHES["paged_decode"] - before}
    if scrape:
        out.update(scrapes=scraper.counts, misses=scraper.misses,
                   tables_with_rows=scraper.tables_with_rows,
                   states=sorted(scraper.states))
    del engine
    torch.cuda.empty_cache()
    return out


def fleet_windows(steps, window: int) -> list:
    """The records' steps at which the fleet monitor closes a window (its
    cadence rule: the first record anchors, a later one closes when its
    step enters a new bucket of ``window`` steps)."""
    closed, last = [], None
    for st in steps:
        bucket = st // window
        if last is not None and bucket > last:
            closed.append(st)
        if last is None or bucket > last:
            last = bucket
    return closed


def fleet_ops(ops) -> dict:
    """GPT-base bf16 with telemetry, tracing, health and attribution,
    without and with ``FleetConfig(window_steps=2)`` and
    ``OpsPlaneConfig(port=0)`` over the same batches: losses, masters,
    dispatches and flash launches equal (bit for bit), a window captured
    in each; the ``fleet/*`` fields on the window boundaries, ``hosts`` 1;
    every endpoint 200 in its shape while a thread scrapes them; /profile
    scraped from another thread during training: 200, 409 while it runs,
    429 past the budget of one, 405 for a POST, and its trace names the
    three flash kernels; then ``Stoke.serve()`` of each run, the plane's
    engine attached to /requests, scraped while it drives: the decode
    kernel launched, the streams equal, TPOT p50 of both."""
    import shutil
    import tempfile

    from stoke_tpu_torch.telemetry.events import read_step_events

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="stoke-fleet-")
    try:
        batches = window_batches(FLEET_EAGER + 4 + FLEET_TIMED)
        plain = fleet_run(ops, batches, False, root)
        obs = fleet_run(ops, batches, True, root)
        served_plain = fleet_serve(ops, plain["stoke"], False)
        served = fleet_serve(ops, obs["stoke"], True)
        prof = obs["profile"]
        first = prof.get("first", (None, {}))
        trace_file = os.path.join(str(first[1].get("trace_dir")),
                                  "stoke.rank0.pt.trace.json")
        profiled = {}
        if os.path.exists(trace_file):
            with open(trace_file) as f:
                text = f.read()
            profiled = {k: text.count(k) for k in WGMMA_KERNELS}
        for key in ("plain", "obs"):
            run = plain if key == "plain" else obs
            run.pop("stoke").close_telemetry()
        recs = read_step_events(os.path.join(root, "fleetTrue",
                                             "steps.jsonl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    for key in ("losses", "digest", "launches", "dispatches",
                "windows_captured"):
        if plain[key] != obs[key]:
            failures.append(f"{key}: {obs[key]} vs {plain[key]}")
    if obs["windows_captured"] != 1:
        failures.append(f"windows captured {obs['windows_captured']}")
    steps = [r["step"] for r in recs]
    want = fleet_windows(steps, FLEET_WINDOW)
    got = [r["step"] for r in recs if r["fleet/hosts"] is not None]
    if got != want or not got:
        failures.append(f"fleet windows at {got}, expected {want}")
    if any(r["fleet/hosts"] not in (None, 1) for r in recs):
        failures.append("fleet/hosts other than 1")
    if not all("fleet/window" in r for r in recs):
        failures.append("a record lacks the fleet fields")
    if obs["scrape_misses"] or not all(obs["scrapes"].values()):
        failures.append(f"scrapes {obs['scrapes']}: {obs['scrape_misses']}")
    codes = (first[0], prof.get("in_flight"), prof.get("past_budget"),
             prof.get("post"))
    if codes != (200, 409, 429, 405) or obs["profile_alive"]:
        failures.append(f"/profile codes {codes} (alive "
                        f"{obs['profile_alive']}): {first[1]}")
    if not profiled or not all(profiled.values()):
        failures.append(f"the /profile trace names the flash kernels "
                        f"{profiled}")
    if served["streams"] != served_plain["streams"]:
        failures.append("the plane's engine streams differ")
    if not served["paged_decode"] or served["misses"] \
            or not served["tables_with_rows"] \
            or not all(served["scrapes"].values()):
        failures.append(f"serve under the plane: decode launches "
                        f"{served['paged_decode']}, /requests tables with "
                        f"rows {served['tables_with_rows']}, misses "
                        f"{served['misses']}")
    if failures:
        raise AssertionError("fleet_ops: " + "; ".join(failures))
    summary = obs["fleet_summary"]
    return {
        "phase": "fleet_ops",
        "model": "GPT-base bf16, B=8, L=1024, flash, AdamW, clip 1.0; "
                 "Stoke.serve() of its weights on the serve trace",
        "bit_for_bit": True,
        "launches": {**obs["launches"],
                     "paged_decode": served["paged_decode"]},
        "eager_ms_p50": {"plain": plain["eager_ms_p50"],
                         "fleet_plane": obs["eager_ms_p50"]},
        "replayed_ms_p50": {"plain": plain["replayed_ms_p50"],
                            "fleet_plane": obs["replayed_ms_p50"]},
        "eager_ms": {"plain": plain["eager_ms"], "fleet_plane":
                     obs["eager_ms"]},
        "profiled_steps": obs["profiled_steps"],
        "replayed_ms": {"plain": plain["replayed_ms"],
                        "fleet_plane": obs["replayed_ms"]},
        "fleet_window_steps": got,
        "fleet_windows": summary["windows"],
        "fleet_last_verdict": summary["last_verdict"],
        "scrapes": obs["scrapes"],
        "profile": {"codes": list(codes), "seconds": first[1]["seconds"],
                    "kernel_events": profiled},
        "serve": {"tpot_p50_s": {"plain": served_plain["tpot_p50_s"],
                                 "plane_scraped": served["tpot_p50_s"]},
                  "wall_s": {"plain": served_plain["wall_s"],
                             "plane_scraped": served["wall_s"]},
                  "paged_decode": served["paged_decode"],
                  "requests_scrapes": served["scrapes"]["/requests"],
                  "tables_with_rows": served["tables_with_rows"],
                  "states": served["states"]},
        "seconds": time.perf_counter() - t0,
    }


SEQPAR_STEPS = 3         # eager train_steps, then 2 windows (one replayed)
SEQPAR_S, SEQPAR_L, SEQPAR_B = 4, 4096, 2   # the virtual ring
SEQPAR_IMPLS = ("ring", "zigzag", "ulysses")


def seqpar_model(impl: str):
    """GPT-base (the train phase's model) with ``impl``'s attention."""
    from stoke_tpu_torch.ops import attention as sp

    model = gpt_base("flash")
    fn = {"flash": None,
          "ring": lambda: sp.make_ring_attention(causal=True),
          "zigzag": sp.make_zigzag_ring_attention,
          "ulysses": lambda: sp.make_ulysses_attention(causal=True)}[impl]
    if fn is not None:
        for block in model.layers:
            block.attention.attention_fn = fn()
    return model


def seqpar_run(ops, impl: str, batches) -> dict:
    """GPT-base bf16 trained SEQPAR_STEPS eager steps and ``train_steps``
    of two windows; under ``impl`` on a (data=1, seq=1) mesh with
    ``shard_seq_dim=1`` (a one-process NCCL group), or plain flash."""
    from stoke_tpu_torch.configs import DataParallelConfig, MeshConfig

    flags = {}
    if impl != "flash":
        flags = dict(distributed="dp", configs=[
            MeshConfig(axes=("data", "seq"), shape=(1, 1)),
            DataParallelConfig(shard_seq_dim=1)])
    before = dict(ops.LAUNCHES)
    s = stoke_for(seqpar_model(impl), "bf16", TRAIN_BATCH, seed=SEED,
                  **flags)
    losses, ms = eager_steps(s, [batches[i] for i in range(SEQPAR_STEPS)])
    seg = batches[SEQPAR_STEPS:SEQPAR_STEPS + 2]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    out = {"losses": losses, "digest": masters_digest(s),
           "launches": flash_delta(ops, before), "eager_ms": ms,
           "windows_captured": len(s._engine._windows),
           "layout": None if s.seq_shard is None else s.seq_shard.layout}
    del s
    torch.cuda.empty_cache()
    return out


#: warmed, uninstrumented passes timed of the virtual ring and of the
#: whole-sequence flash call it is held against (the median is kept)
SEQPAR_TIMED = 3


def virtual_ring_inputs(gen, zigzag: bool) -> dict:
    """The virtual ring's inputs: q, k, v and dO of S=4 shards of L=4096
    (B=2, H=12, D=64, bf16) in natural order, and the layout's order."""
    from stoke_tpu_torch.ops import attention as sp

    S, L, B = SEQPAR_S, SEQPAR_L, SEQPAR_B
    shape = (B, HEADS, L, HEAD_DIM)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=BF16) for _ in range(4))
    perm = (torch.as_tensor(sp.zigzag_permutation(L, S), device="cuda")
            if zigzag else torch.arange(L, device="cuda"))
    return {"q": q, "k": k, "v": v, "do": do, "perm": perm,
            "zigzag": zigzag}


def virtual_ring_pass(inp: dict) -> tuple:
    """One forward and backward of the S virtual shards in one process,
    the rotation handed in: the ring (or the zigzag ring over the zigzag
    layout). Returns the whole output in the layout's order and the
    (q, k, v) leaves in that order, their gradients filled."""
    from stoke_tpu_torch.ops import attention as sp

    S, zigzag, perm = SEQPAR_S, inp["zigzag"], inp["perm"]
    leaves = [inp[n].index_select(2, perm).detach().requires_grad_()
              for n in ("q", "k", "v")]
    Ls = SEQPAR_L // S
    qs, ks, vs = ([t[:, :, r * Ls:(r + 1) * Ls] for r in range(S)]
                  for t in leaves)
    layout = "zigzag" if zigzag else "contiguous"
    fn = sp.zigzag_ring_attention if zigzag else sp.ring_attention
    kw = {} if zigzag else {"causal": True, "inner": "flash"}
    out = torch.cat([fn(qs[r], ks[r], vs[r], None,
                        shard=sp.SeqShard(None, r, S, layout),
                        rotate=sp.virtual_ring(ks, vs, None, r), **kw)
                     for r in range(S)], dim=2)
    out.backward(inp["do"].index_select(2, perm))
    return out, leaves


def whole_flash_pass(ops, inp: dict) -> list:
    """One causal flash call over the whole sequence and its backward:
    the output and the gradients of q, k and v."""
    leaves = [inp[n].detach().clone().requires_grad_()
              for n in ("q", "k", "v")]
    ref = ops.flash_attention(*leaves, None, causal=True)
    ref.backward(inp["do"])
    return [ref.detach()] + [t.grad for t in leaves]


def virtual_ring(ops, gen, zigzag: bool) -> dict:
    """S=4 virtual shards of L=4096 (B=2, H=12, D=64, bf16) in one
    process (:func:`virtual_ring_pass`) against one causal flash call over
    the whole sequence and its backward: outputs within FWD_ATOL_BF16,
    the gradients' rows within BWD_ROW_RTOL_BF16 (``bwd_row_err``); every
    fully masked hop's output exactly 0 and its LSE -1e30 (recorded in
    this checking pass only); the hops' forward launches S^2 (ring) or
    3 S^2 (zigzag). Then the host ms of SEQPAR_TIMED warmed passes of
    each, uninstrumented (the median)."""
    from stoke_tpu_torch.ops import attention as sp

    inp = virtual_ring_inputs(gen, zigzag)
    hops = []
    real_flash = sp.flash_attention

    def recording(qh, kh, vh, mask=None, **kw):
        out = real_flash(qh, kh, vh, mask, **kw)
        if (kw.get("return_lse") and mask is not None
                and not bool(mask.any())):
            hops.append((out[0].detach().clone(), out[1].detach().clone()))
        return out

    before = dict(ops.LAUNCHES)

    sp.flash_attention = recording
    try:
        out, leaves = virtual_ring_pass(inp)
    finally:
        sp.flash_attention = real_flash
    launches = {n: ops.LAUNCHES[n] - before[n] for n in FLASH}
    inv = torch.argsort(inp["perm"])
    got = [out.detach().index_select(2, inv)] + [
        t.grad.index_select(2, inv) for t in leaves]
    refs = whole_flash_pass(ops, inp)
    err = max_err(got[0], refs[0])
    rows = {n: ops.bwd_row_err(g, r) for n, g, r in
            zip(("dq", "dk", "dv"), got[1:], refs[1:])}
    zero_hops = all(bool((o == 0).all()) and bool((l == ops.NEG_INF).all())
                    for o, l in hops)
    want = (3 if zigzag else 1) * SEQPAR_S ** 2
    ok = (err <= ops.FWD_ATOL_BF16 and zero_hops and hops
          and all(e <= ops.BWD_ROW_RTOL_BF16 for e in rows.values())
          and launches["flash_fwd"] == want
          and launches["flash_bwd_dq"] == want
          and launches["flash_bwd_dkv"] == want)
    del out, leaves, got, refs
    ring_ms = [timed_ms(lambda: virtual_ring_pass(inp))
               for _ in range(SEQPAR_TIMED)]
    whole_ms = [timed_ms(lambda: whole_flash_pass(ops, inp))
                for _ in range(SEQPAR_TIMED)]
    return {"S": SEQPAR_S, "L": SEQPAR_L, "B": SEQPAR_B,
            "layout": "zigzag" if zigzag else "contiguous", "ok": bool(ok),
            "max_abs_err": err, "bwd_row_err": rows,
            "fully_masked_hops": len(hops), "fully_masked_exact": zero_hops,
            "hop_forwards": launches["flash_fwd"],
            "expected_hop_forwards": want,
            "launches": launches, "ring_ms": float(np.median(ring_ms)),
            "ring_ms_each": ring_ms,
            "whole_flash_ms": float(np.median(whole_ms)),
            "whole_flash_ms_each": whole_ms}


def train_seqpar(ops) -> dict:
    """Sequence parallelism on the card. GPT-base bf16 (the train
    phase's model) at world 1 under a (data=1, seq=1) mesh with
    ``shard_seq_dim=1`` through ring, zigzag and Ulysses attention, each
    against plain flash attention over the same batches: losses, masters
    and flash launches bit for bit, eager and replayed (a one-hop ring is
    one flash call and a bf16 -> fp32 -> bf16 round trip; one zigzag shard
    one causal flash call; Ulysses of one shard one flash call). Then S=4
    virtual shards of L=4096 in one process, the ring and the zigzag ring,
    forward and backward against one causal flash over the whole sequence
    (:func:`virtual_ring`)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    batches = window_batches(SEQPAR_STEPS + 2)
    # the one-process NCCL group goes on failure too (its watchdog would
    # hold the process for minutes)
    try:
        runs = {impl: seqpar_run(ops, impl, batches)
                for impl in ("flash",) + SEQPAR_IMPLS}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    failures = []
    for impl in SEQPAR_IMPLS:
        for key in ("losses", "digest", "launches", "windows_captured"):
            if runs[impl][key] != runs["flash"][key]:
                failures.append(f"{impl} {key}: {runs[impl][key]} vs "
                                f"{runs['flash'][key]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    virtual = {name: virtual_ring(ops, gen, name == "zigzag")
               for name in ("ring", "zigzag")}
    for name, res in virtual.items():
        if not res["ok"]:
            failures.append(f"virtual {name}: {res}")
    if failures:
        raise AssertionError("train_seqpar: " + "; ".join(failures))
    steps = SEQPAR_STEPS + 2
    return {
        "phase": "train_seqpar",
        "model": "GPT-base bf16, B=8, L=1024, AdamW, clip 1.0, under a "
                 "(data=1, seq=1) mesh with shard_seq_dim=1",
        "bit_for_bit": True,
        "losses": runs["flash"]["losses"],
        "layouts": {i: runs[i]["layout"] for i in SEQPAR_IMPLS},
        "launches": {i: runs[i]["launches"] for i in runs},
        "launches_total": {n: sum(runs[i]["launches"][n] for i in runs)
                           + sum(v["launches"][n] for v in virtual.values())
                           for n in FLASH},
        "eager_ms": {i: runs[i]["eager_ms"] for i in runs},
        "steps": steps,
        "virtual": virtual,
        "seconds": time.perf_counter() - t0,
    }


TPEP_STEPS = 5           # train_steps a run: eager, or 3 eager then 2 windows
TPEP_EAGER = 3           # eager steps before the windows
TPEP_SPLITS = (2, 4)     # the virtual model and expert group sizes
TPEP_REPLAYS = 4         # timed one-window replays
MOE_EXPERTS, MOE_EVERY, MOE_CAPACITY = 8, 2, 1.25


def moe_base(top_k: int):
    """GPT-base-MoE on the card (the train phase's GPT-base with a switch
    MoE of MOE_EXPERTS experts in every MOE_EVERY-th block, capacity
    MOE_CAPACITY), seeded weights, flash attention."""
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.ops import make_flash_attention

    model = GPT(vocab_size=VOCAB, size_name="base", max_len=1024,
                dropout_rate=0.0,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True, moe_num_experts=MOE_EXPERTS,
                moe_every=MOE_EVERY, moe_capacity_factor=MOE_CAPACITY,
                moe_top_k=top_k, device="cuda")
    model.init_weights(SEED)
    return model


def peak_start() -> int:
    """Collect the garbage, reset the allocator's peak statistic and
    return the bytes allocated then: a run's peak is its rise above them
    (tensors an earlier phase left alive count in the process's peak, not
    in it; unreachable ones, which the collector could free during the
    run, are freed first)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peaks(start: int) -> dict:
    """The run's peak above ``start`` and the process's, in GB."""
    top = torch.cuda.max_memory_allocated()
    return {"peak_gb": (top - start) / 1e9, "process_peak_gb": top / 1e9}


def split_run(ops, make, axes, rules, batches, windows: bool,
              replays: int = 0) -> dict:
    """``make()``'s model trained bf16 TPEP_STEPS steps: all eager, or
    TPEP_EAGER eager then ``train_steps`` of two one-step windows (the
    second replayed) and ``replays`` timed one-window replays; under
    ``rules`` on a (1, 1) mesh of ``axes`` (a one-process NCCL group), or
    without ``distributed``. The peak is the run's, the model's weights
    included (``make`` runs after the reset)."""
    from stoke_tpu_torch.configs import MeshConfig, PartitionRulesConfig

    flags = {}
    if rules is not None:
        flags = dict(distributed="dp", configs=[
            MeshConfig(axes=axes, shape=(1, 1)),
            PartitionRulesConfig(rules=rules)])
    before = dict(ops.LAUNCHES)
    start = peak_start()
    s = stoke_for(make(), "bf16", TRAIN_BATCH, seed=SEED, **flags)
    n = TPEP_EAGER if windows else TPEP_STEPS
    losses, ms = eager_steps(s, [batches[i] for i in range(n)])
    replay_ms = []
    if windows:
        seg = batches[TPEP_EAGER:TPEP_STEPS]
        losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
        one = batches[TPEP_STEPS - 1:TPEP_STEPS]
        replay_ms = [timed_ms(lambda: s.train_steps(one, one))
                     for _ in range(replays)]
    aux = s.aux_losses
    out = {"losses": losses, "launches": flash_delta(ops, before),
           "digest": masters_digest(s), "eager_ms": ms,
           "replay_ms": replay_ms,
           "windows_captured": len(s._engine._windows),
           **peaks(start),
           "aux": None if aux is None else [
               float(v["moe"]["aux_loss"]) for v in aux.values()],
           "split": None if s.tensor_parallel is None else sorted(
               {n.split(".")[-2] + "." + n.split(".")[-1]
                for n in s.tensor_parallel.cuts})}
    del s
    torch.cuda.empty_cache()
    return out


def joined_grads(whole, ranks, tps) -> dict:
    """Each parameter's gradient of the split ranks, the cut ones put
    back whole, the others (biases, norms) from ``whole``."""
    out = {}
    for n, p in whole.named_parameters():
        cut = tps[0].cuts.get(n)
        out[n] = (p.grad if cut is None else cut.join(
            [dict(r.named_parameters())[n].grad for r in ranks]))
    return out


def block_pass(module, x, dout, call) -> tuple:
    """``call(module, x)`` and its backward of ``dout``: the output and
    every gradient (``x``'s as ``"x"``) by name."""
    x = x.clone().requires_grad_()
    out = call(module, x)
    out.backward(dout)
    grads = {n: p.grad for n, p in module.named_parameters()}
    grads["x"] = x.grad
    return out.detach(), grads


def split_errors(split, refs, dtype) -> dict:
    """The split's output and each gradient against ``refs[-1]``, by the
    largest absolute difference over the largest magnitude in fp32
    (held to PARITY_RTOL) and by the row check (``bwd_row_err``) in bf16
    (held to BWD_ROW_RTOL_BF16). ``refs`` is the unsplit block's pass;
    for a bf16 split that rounds its partial sums otherwise than the
    unsplit block, also the unsplit fp32 block's, which both bf16 passes
    are then held against: each of the split's tensors within
    BWD_ROW_RTOL_BF16 or, where the unsplit bf16 block's own error of
    that tensor is above half of it (a weight gradient's rows summed over
    8192 tokens), within twice that error."""
    fa = importlib.import_module("stoke_tpu_torch.ops.flash_attention")

    def err(a, b):
        if dtype == FP32:
            return float((a - b).abs().max() / b.abs().max())
        # a vector is one row
        return fa.bwd_row_err(a.reshape(-1, a.shape[-1]),
                              b.reshape(-1, b.shape[-1]))

    def errs(got):
        ref = refs[-1]
        out = {"out": err(got[0], ref[0])}
        out.update({n: err(got[1][n], ref[1][n]) for n in ref[1]})
        return out

    mine = errs(split)
    k = max(mine, key=mine.get)
    limit = PARITY_RTOL if dtype == FP32 else fa.BWD_ROW_RTOL_BF16
    if len(refs) == 1:
        return {"max_err": mine[k], "worst": k, "limit": limit,
                "ok": mine[k] <= limit}
    theirs = errs(refs[0])
    limits = {n: max(limit, 2 * theirs[n]) for n in mine}
    return {"max_err": mine[k], "worst": k, "limit": limits[k],
            "unsplit_err": theirs[k],
            "unsplit_max_err": max(theirs.values()),
            "ok": all(mine[n] <= limits[n] for n in mine)}


def virtual_tp(ops, T: int, dtype) -> dict:
    """One GPT-base block (flash attention, causal) split over T virtual
    model ranks by the port's own cut (``shard_module`` with
    ``gpt_tensor_parallel_rules``): each rank's column- and row-parallel
    products on the card at 12 / T heads and 3072 / T ff, the partial
    outputs summed here in place of the all-reduce, the row biases added
    once; forward and every gradient against the unsplit block."""
    import copy

    from stoke_tpu_torch.models.bert import TransformerBlock
    from stoke_tpu_torch.models import gpt_tensor_parallel_rules
    from stoke_tpu_torch.ops import make_flash_attention
    from stoke_tpu_torch.parallel import ModelGroup, shard_module

    torch.manual_seed(SEED + T)
    whole = TransformerBlock(HEADS * HEAD_DIM, HEADS, 4 * HEADS * HEAD_DIM,
                             0.0, make_flash_attention(causal=True),
                             device="cuda").to(dtype)
    base = copy.deepcopy(whole)
    x = torch.randn(TRAIN_BATCH, TRAIN_LEN, HEADS * HEAD_DIM,
                    device="cuda", dtype=dtype)
    dout = torch.randn_like(x)
    # the fp32 copy before the pass (a pass leaves a MoE FFN its aux)
    whole32 = copy.deepcopy(whole).float() if dtype != FP32 else None
    refs = [block_pass(whole, x, dout, lambda m, t: m(t, None))]
    if whole32 is not None:
        refs.append(block_pass(whole32, x.float(), dout.float(),
                               lambda m, t: m(t, None)))
    ranks, tps = [], []
    for r in range(T):
        b = copy.deepcopy(base)
        tps.append(shard_module(b, gpt_tensor_parallel_rules(),
                                ModelGroup(None, T, r, "model")))
        ranks.append(b)
    before = dict(ops.LAUNCHES)
    xs = x.clone().requires_grad_()
    a = sum(b.attention.partial(xs, None) for b in ranks)
    h = base.ln_attn(xs + a + base.attention.out.bias)
    f = sum(b.ff_partial(h) for b in ranks) + base.ff_out.bias
    out = base.ln_ff(h + f)
    out.backward(dout)
    launches = flash_delta(ops, before)
    grads = joined_grads(base, ranks, tps)
    grads["x"] = xs.grad
    res = split_errors((out.detach(), grads), refs, dtype)
    res.update(T=T, dtype=str(dtype).replace("torch.", ""),
               heads_a_rank=ranks[0].attention.local_heads,
               ff_a_rank=ranks[0].ff_in.out_features, launches=launches)
    res["ok"] = res["ok"] and all(v == T for v in launches.values())
    return res


def virtual_ep(X: int, dtype) -> dict:
    """The MoE FFN of a GPT-base-MoE block (8 experts, capacity 1.25,
    top-2) split over X virtual expert ranks by the port's own cut
    (``moe_expert_parallel_rules``): routing and dispatch once, each
    rank's experts on the card, their outputs gathered here, combined;
    forward and every gradient against the unsplit FFN."""
    import copy

    from stoke_tpu_torch.models import MoEFFN, moe_expert_parallel_rules
    from stoke_tpu_torch.parallel import ModelGroup, shard_module

    torch.manual_seed(SEED + X)
    H = HEADS * HEAD_DIM
    whole = MoEFFN(H, 4 * H, MOE_EXPERTS, MOE_CAPACITY, top_k=2,
                   device="cuda").to(dtype)
    base = copy.deepcopy(whole)
    x = torch.randn(TRAIN_BATCH, TRAIN_LEN, H, device="cuda", dtype=dtype)
    dout = torch.randn_like(x)
    # each expert is computed whole on its rank: the split is held to the
    # unsplit FFN of its own dtype (in bf16 an fp32 reference would route
    # its near ties otherwise)
    refs = [block_pass(whole, x, dout, lambda m, t: m(t))]
    ranks, tps = [], []
    for r in range(X):
        m = copy.deepcopy(base)
        tps.append(shard_module(m, moe_expert_parallel_rules(),
                                ModelGroup(None, X, r, "expert")))
        ranks.append(m)
    xs = x.clone().requires_grad_()
    slot, gates = base.route(xs)
    expert_in = base.dispatch(xs, slot)
    n = MOE_EXPERTS // X
    outs = [m.experts(expert_in[r * n:(r + 1) * n])
            for r, m in enumerate(ranks)]
    out = MoEFFN.combine(torch.cat(outs), slot, gates)
    out.backward(dout)
    grads = joined_grads(base, ranks, tps)
    grads["x"] = xs.grad
    res = split_errors((out.detach(), grads), refs, dtype)
    res.update(X=X, dtype=str(dtype).replace("torch.", ""),
               experts_a_rank=ranks[0].local_experts,
               capacity=base.capacity(TRAIN_LEN))
    return res


def moe_block_profile() -> dict:
    """Device ms of one MoE FFN of GPT-base-MoE (bf16, top-1 and top-2,
    B=8, L=1024) forward and backward under ``torch.profiler``: the
    forward's kernels by region (routing, dispatch, the experts'
    products, combine) and the whole pass's product kernels (cuBLAS's
    GEMMs by name: the experts' and the router's) against the rest
    (routing, dispatch, combine, gelu)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from stoke_tpu_torch.models import MoEFFN

    H = HEADS * HEAD_DIM
    out = {}
    for k in (1, 2):
        torch.manual_seed(SEED)
        moe = MoEFFN(H, 4 * H, MOE_EXPERTS, MOE_CAPACITY, top_k=k,
                     device="cuda").to(BF16)
        x = torch.randn(TRAIN_BATCH, TRAIN_LEN, H, device="cuda",
                        dtype=BF16, requires_grad=True)

        def once():
            with record_function("moe/route"):
                slot, gates = moe.route(x)
            with record_function("moe/dispatch"):
                ein = moe.dispatch(x, slot)
            with record_function("moe/experts"):
                eo = moe.experts(ein)
            with record_function("moe/combine"):
                y = moe.combine(eo, slot, gates)
            y.float().pow(2).mean().backward()

        once()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            once()
            torch.cuda.synchronize()
        regions = {}
        for e in prof.events():
            if e.name.startswith("moe/") and e.device_type == DeviceType.CPU:
                regions[e.name] = getattr(e, "device_time_total", 0.0) / 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        ms = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key)
              for e in kernels]
        gemm = sum(t for t, n in ms if re.search(
            r"gemm|xmma|cutlass|sm90_|nvjet", n, re.I))
        total = sum(t for t, _ in ms)
        out[f"top{k}"] = {
            "forward_regions_ms": regions,
            "device_ms": total, "product_kernels_ms": gemm,
            "routing_dispatch_combine_ms": total - gemm,
            "routing_share": (total - gemm) / total if total else None,
            "top": [{"name": n[:80], "ms": t}
                    for t, n in sorted(ms, reverse=True)[:6]]}
        del moe, x
    return out


def train_tp_ep(ops) -> dict:
    """Tensor and expert parallelism on the card. GPT-base bf16 (the
    train phase's model) at world 1 under ``gpt_tensor_parallel_rules``
    on a (data=1, model=1) mesh, against the same run without rules:
    losses, masters and flash launches bit for bit, eager and replayed.
    One GPT-base block split over T = 2 and 4 virtual model ranks
    (:func:`virtual_tp`) in fp32 and bf16. GPT-base-MoE top-1 and top-2
    on one batch every step: all eager against eager then replayed
    windows (within WINDOW_RTOL), the loss falls, the aux losses finite
    and >= 1 - 1e-5, the windowed
    run under ``moe_expert_parallel_rules`` on a (data=1, expert=1) mesh
    bit for bit; its experts split over X = 2 and 4 virtual expert ranks
    (:func:`virtual_ep`); step ms eager and replayed, peak memory, and
    the MoE FFN's routing against its products (:func:`moe_block_profile`)."""
    import torch.distributed as dist

    from stoke_tpu_torch.models import (
        gpt_tensor_parallel_rules,
        moe_expert_parallel_rules,
    )

    t0 = time.perf_counter()
    batches = window_batches(TPEP_STEPS)
    failures = []
    runs = {}
    # the one-process NCCL group goes on failure too (its watchdog would
    # hold the process for minutes)
    try:
        def gpt():
            return gpt_base("flash")

        runs["gpt"] = split_run(ops, gpt, None, None, batches, True)
        runs["gpt_tp"] = split_run(ops, gpt, ("data", "model"),
                                   gpt_tensor_parallel_rules(), batches,
                                   True)
        # the MoE runs take one batch every step, so that five steps at
        # the train phase's learning rate show the loss falling
        same = batches[:1].expand_as(batches).contiguous()
        for k in (1, 2):
            def moe(k=k):
                return moe_base(k)

            runs[f"moe{k}_eager"] = split_run(ops, moe, None, None, same,
                                              False)
            runs[f"moe{k}"] = split_run(ops, moe, None, None, same, True,
                                        TPEP_REPLAYS)
            runs[f"moe{k}_ep"] = split_run(
                ops, moe, ("data", "expert"), moe_expert_parallel_rules(),
                same, True, TPEP_REPLAYS)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for plain, split in (("gpt", "gpt_tp"), ("moe1", "moe1_ep"),
                         ("moe2", "moe2_ep")):
        for key in ("losses", "digest", "launches", "windows_captured",
                    "aux"):
            if runs[split][key] != runs[plain][key]:
                failures.append(f"{split} {key}: {runs[split][key]} vs "
                                f"{runs[plain][key]}")
        if not runs[split]["split"]:
            failures.append(f"{split}: nothing split")
    for k in (1, 2):
        eager, win = runs[f"moe{k}_eager"], runs[f"moe{k}"]
        diff = rel_diff(win["losses"], eager["losses"])
        if diff > WINDOW_RTOL:
            failures.append(f"moe{k} windows vs eager: {diff}")
        if not eager["losses"][-1] < eager["losses"][0]:
            failures.append(f"moe{k}: loss did not fall {eager['losses']}")
        if not all(np.isfinite(a) and a >= 1 - 1e-5 for a in win["aux"]):
            failures.append(f"moe{k}: aux {win['aux']}")
        if win["windows_captured"] < 1:
            failures.append(f"moe{k}: no window captured")
        win["windows_vs_eager"] = diff
    want = {n: (TPEP_STEPS + TPEP_REPLAYS) * N_LAYERS for n in FLASH}
    if runs["moe1"]["launches"] != want:
        failures.append(f"moe1 launches {runs['moe1']['launches']} vs {want}")
    virtual = {"tp": [virtual_tp(ops, T, dt) for dt in (FP32, BF16)
                      for T in TPEP_SPLITS],
               "ep": [virtual_ep(X, dt) for dt in (FP32, BF16)
                      for X in TPEP_SPLITS]}
    for kind, cases in virtual.items():
        for c in cases:
            if not c["ok"]:
                failures.append(f"virtual {kind}: {c}")
    if failures:
        raise AssertionError("train_tp_ep: " + "; ".join(failures))
    profile = moe_block_profile()

    def p50(xs):
        return float(np.median(xs)) if xs else None

    return {
        "phase": "train_tp_ep",
        "model": "GPT-base and GPT-base-MoE (8 experts every 2nd block, "
                 "capacity 1.25) bf16, B=8, L=1024, AdamW, clip 1.0",
        "bit_for_bit": True,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "aux_losses": {k: runs[k]["aux"] for k in ("moe1", "moe2")},
        "split": {k: runs[k]["split"] for k in ("gpt_tp", "moe1_ep")},
        "windows_vs_eager": {k: runs[k]["windows_vs_eager"]
                             for k in ("moe1", "moe2")},
        "eager_ms_p50": {k: p50(v["eager_ms"][2:]) for k, v in runs.items()
                         if k.endswith("_eager")},
        "eager_ms": {k: v["eager_ms"] for k, v in runs.items()},
        "replay_ms_p50": {k: p50(runs[k]["replay_ms"])
                          for k in ("moe1", "moe2")},
        "replay_ms": {k: runs[k]["replay_ms"] for k in ("moe1", "moe2")},
        "peak_gb": {k: v["peak_gb"] for k, v in runs.items()},
        "process_peak_gb": {k: v["process_peak_gb"]
                            for k, v in runs.items()},
        "launches": {k: v["launches"] for k, v in runs.items()},
        "launches_total": {n: sum(v["launches"][n] for v in runs.values())
                           + sum(c["launches"][n] for c in virtual["tp"])
                           for n in FLASH},
        "virtual": virtual,
        "moe_block": profile,
        "seconds": time.perf_counter() - t0,
    }


PIPE_M = 4                # microbatches a batch
PIPE_EAGER, PIPE_STEPS = 3, 5  # eager steps, then windows up to PIPE_STEPS
PIPE_REPLAYS = 4         # timed one-window replays
#: the schedules at world 1: GPipe, and circular with remat
PIPE_SCHEDULES = {"gpipe": dict(rounds=1),
                  "circular": dict(rounds=2, remat=True,
                                   layers_per_stage=6)}
#: the virtual stage counts S and their rounds V, 3 blocks a stage
PIPE_VIRTUAL = ((2, 2), (4, 1))
PIPE_VIRTUAL_LAYERS = 3
#: the virtual stages run each microbatch through the unsplit stack's
#: operations; only the stacked gradients' sums over the microbatches
#: may round otherwise
PIPE_FP32_RTOL = 1e-5


def pipelined_lm(rounds: int = 1, remat: bool = False,
                 layers_per_stage=None, stages: int = 1):
    """PipelinedLM at GPT-base width (12 blocks over ``rounds * stages``
    stages) on the card, seeded."""
    from stoke_tpu_torch.models import PipelinedLM

    model = PipelinedLM(vocab_size=VOCAB, size_name="base", max_len=1024,
                        num_microbatches=PIPE_M,
                        layers_per_stage=layers_per_stage, rounds=rounds,
                        remat=remat, stages=stages, device="cuda")
    model.init_weights(SEED)
    return model


def pipeline_run(ops, schedule: dict, mesh: bool, batches) -> dict:
    """PipelinedLM (``schedule``'s options) trained bf16: PIPE_EAGER
    eager steps, ``train_steps`` of two one-step windows (the second
    replayed), PIPE_REPLAYS timed one-window replays; under
    ``pipeline_parallel_rules`` on a (data=1, stage=1) mesh, or without
    ``distributed``."""
    from stoke_tpu_torch.configs import MeshConfig, PartitionRulesConfig
    from stoke_tpu_torch.models import pipeline_parallel_rules

    flags = {}
    if mesh:
        flags = dict(distributed="dp", configs=[
            MeshConfig(axes=("data", "stage"), shape=(1, 1)),
            PartitionRulesConfig(rules=pipeline_parallel_rules())])
    before = dict(ops.LAUNCHES)
    start = peak_start()
    s = stoke_for(pipelined_lm(**schedule), "bf16", TRAIN_BATCH, seed=SEED,
                  **flags)
    losses, ms = eager_steps(s, [batches[i] for i in range(PIPE_EAGER)])
    seg = batches[PIPE_EAGER:PIPE_STEPS]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    one = batches[PIPE_STEPS - 1:PIPE_STEPS]
    replay_ms = [timed_ms(lambda: s.train_steps(one, one))
                 for _ in range(PIPE_REPLAYS)]
    tp = s.tensor_parallel
    out = {"losses": losses, "launches": flash_delta(ops, before),
           "digest": masters_digest(s), "eager_ms": ms,
           "replay_ms": replay_ms,
           "windows_captured": len(s._engine._windows), **peaks(start),
           "cut": None if tp is None else len(tp.cuts),
           "stages_held": int(s.model_access.stages.block_0.ln_ff.weight
                              .shape[0])}
    del s
    torch.cuda.empty_cache()
    return out


def stack_errors(got, ref) -> dict:
    """Each tensor of ``got`` against ``ref`` (``(out, grads)``): the
    largest absolute difference over ``ref``'s largest magnitude."""
    out = {"out": float((got[0].float() - ref[0].float()).abs().max()
                        / ref[0].float().abs().max())}
    for n, g in got[1].items():
        r = ref[1][n].float()
        out[n] = float((g.float() - r).abs().max() / r.abs().max())
    return out


def virtual_stages(S: int, V: int, dtype) -> dict:
    """The 12 blocks of PipelinedLM at GPT-base width as V·S stages of
    PIPE_VIRTUAL_LAYERS, over S virtual stages in one process
    (``virtual_pipeline``): one forward and backward of PIPE_M
    microbatches of B/M rows, L=1024, against the unsplit stack (each
    microbatch through the V·S stages in turn) on the same inputs and
    cotangent, in ``dtype``; bf16 also against the fp32 stack."""
    from torch.func import functional_call

    from stoke_tpu_torch.parallel import Schedule, virtual_pipeline

    torch.manual_seed(SEED + S)
    m = pipelined_lm(rounds=V, layers_per_stage=PIPE_VIRTUAL_LAYERS,
                     stages=S)
    H = HEADS * HEAD_DIM
    causal = torch.tril(torch.ones(TRAIN_LEN, TRAIN_LEN, dtype=torch.bool,
                                   device="cuda"))
    x32 = torch.randn(PIPE_M, TRAIN_BATCH // PIPE_M, TRAIN_LEN, H,
                      device="cuda")
    dout32 = torch.randn_like(x32)
    # the bf16 pass's parameters and inputs, and the fp32 reference of
    # the same values
    base = {n: p.detach().to(dtype) for n, p in m.stages.named_parameters()}

    def stage_fn(dt):
        bias = torch.where(causal, 0.0, -1e9)[None, None].to(dt)
        return lambda p, x: functional_call(m.stages, p, (x, bias))

    def leaves(dt):
        p = {n: t.to(dt, copy=True).requires_grad_()
             for n, t in base.items()}
        return p, x32.to(dtype).to(dt, copy=True).requires_grad_()

    def unsplit(dt):
        p, x = leaves(dt)
        fn = stage_fn(dt)
        slices = {n: t.unbind(0) for n, t in p.items()}
        outs = []
        for i in range(PIPE_M):
            h = x[i]
            for k in range(S * V):
                h = fn({n: t[k] for n, t in slices.items()}, h)
            outs.append(h)
        out = torch.stack(outs)
        out.backward(dout32.to(dt))
        return out.detach(), {**{n: t.grad for n, t in p.items()},
                              "x": x.grad}

    p, x = leaves(dtype)
    run = virtual_pipeline(stage_fn(dtype), S, rounds=V)
    out = torch.cat(run(p, x))
    out.backward(dout32.to(dtype))
    got = (out.detach(), {**{n: t.grad for n, t in p.items()}, "x": x.grad})
    ref = unsplit(dtype)
    mine = stack_errors(got, ref)
    sched = Schedule(S, V, PIPE_M)
    res = {"S": S, "V": V, "dtype": str(dtype).replace("torch.", ""),
           "layers_a_stage": PIPE_VIRTUAL_LAYERS, **run.counts,
           "bubble": 1 - run.counts["useful"] / run.counts["applications"],
           "counts_as_schedule": run.counts == {
               "ticks": sched.ticks, "applications": sched.applications,
               "useful": sched.useful}}
    worst = max(mine, key=mine.get)
    if dtype == FP32:
        res.update(max_rel_err=mine[worst], worst=worst,
                   limit=PIPE_FP32_RTOL,
                   ok=mine[worst] <= PIPE_FP32_RTOL)
    else:
        ref32 = unsplit(FP32)
        vs32, own = stack_errors(got, ref32), stack_errors(ref, ref32)
        limits = {n: max(PIPE_FP32_RTOL, 2 * own[n]) for n in vs32}
        w = max(vs32, key=lambda n: vs32[n] / limits[n])
        res.update(max_rel_err_vs_unsplit_bf16=mine[worst],
                   worst_vs_unsplit_bf16=worst, max_rel_err=vs32[w],
                   worst=w, limit=limits[w], unsplit_err=own[w],
                   unsplit_max_err=max(own.values()),
                   ok=all(vs32[n] <= limits[n] for n in vs32))
    res["ok"] = res["ok"] and res["counts_as_schedule"]
    del m
    torch.cuda.empty_cache()
    return res


def train_pipeline(ops, t_main: float) -> dict:
    """Pipeline parallelism on the card. PipelinedLM at GPT-base width,
    bf16, B=8, L=1024, M=PIPE_M, GPipe and circular with remat, each at
    world 1 under ``pipeline_parallel_rules`` on a (data=1, stage=1) mesh
    against the same run without (:func:`pipeline_run`): losses, masters
    and windows captured bit for bit, no flash launch (the stage's dense
    attention, as the JAX stage); eager and replayed step ms and the
    peak's rise. Then S = 2 and 4 virtual stages against the unsplit
    stack in fp32 and bf16 (:func:`virtual_stages`). ``t_main`` is the
    run's start on the host clock (the line reports both times)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    batches = window_batches(PIPE_STEPS)
    failures = []
    runs = {}
    # the one-process NCCL group goes on failure too
    try:
        for name, schedule in PIPE_SCHEDULES.items():
            runs[name] = pipeline_run(ops, schedule, False, batches)
            runs[f"{name}_mesh"] = pipeline_run(ops, schedule, True, batches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for name in PIPE_SCHEDULES:
        plain, split = runs[name], runs[f"{name}_mesh"]
        for key in ("losses", "digest", "windows_captured"):
            if split[key] != plain[key]:
                failures.append(f"{name}_mesh {key}: {split[key]} vs "
                                f"{plain[key]}")
        if not split["cut"]:
            failures.append(f"{name}_mesh: nothing cut")
        if plain["windows_captured"] < 1:
            failures.append(f"{name}: no window captured")
        if not all(np.isfinite(plain["losses"])):
            failures.append(f"{name}: losses {plain['losses']}")
    for k, r in runs.items():
        if any(r["launches"].values()):
            failures.append(f"{k}: flash launches {r['launches']}")
    virtual = [virtual_stages(S, V, dt) for dt in (FP32, BF16)
               for S, V in PIPE_VIRTUAL]
    for c in virtual:
        if not c["ok"]:
            failures.append(f"virtual stages: {c}")
    if failures:
        raise AssertionError("train_pipeline: " + "; ".join(failures))

    def p50(xs):
        return float(np.median(xs)) if xs else None

    return {
        "phase": "train_pipeline",
        "model": "PipelinedLM at GPT-base width (12 x 768, 12 heads, ff "
                 "3072, vocab 50257, untied head, dense causal attention) "
                 f"bf16, B={TRAIN_BATCH}, L={TRAIN_LEN}, M={PIPE_M}, AdamW, "
                 "clip 1.0",
        "schedules": PIPE_SCHEDULES,
        "bit_for_bit": True,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "digest": {k: v["digest"][:16] for k, v in runs.items()},
        "windows_captured": {k: v["windows_captured"]
                             for k, v in runs.items()},
        "stages_held": {k: v["stages_held"] for k, v in runs.items()},
        "eager_ms_p50": {k: p50(v["eager_ms"]) for k, v in runs.items()},
        "eager_ms": {k: v["eager_ms"] for k, v in runs.items()},
        "replay_ms_p50": {k: p50(v["replay_ms"]) for k, v in runs.items()},
        "replay_ms": {k: v["replay_ms"] for k, v in runs.items()},
        "peak_gb": {k: v["peak_gb"] for k, v in runs.items()},
        "process_peak_gb": {k: v["process_peak_gb"]
                            for k, v in runs.items()},
        "launches": {k: v["launches"] for k, v in runs.items()},
        "launches_total": {n: sum(v["launches"][n] for v in runs.values())
                           for n in FLASH},
        "virtual": virtual,
        "seconds": time.perf_counter() - t0,
        "run_seconds": time.perf_counter() - t_main,
    }


SA_EAGER = 4              # eager steps a run, then a window of SA_WINDOW
SA_WINDOW = 2             # one-step windows (the second replayed)
SA_REPLAYS = 2            # timed one-window replays
SA_SPLIT = 2              # eager steps before the sharded save
#: the tiers under the seq axis, each with an int8 rs_ag transport
SA_TIERS = ("oss", "oss_sddp", "fsdp")
#: the virtual sequence shard counts of the chunked head
SA_SHARDS = (2, 4)
SA_CE_RTOL = 1e-5         # the fp32 chunked head's shards against unsharded
SA_TP = 2                 # the virtual model ranks of the transport layout


def sa_run(ops, mesh, tier: str, batches, device="cuda", layers=N_LAYERS,
           batch=TRAIN_BATCH) -> dict:
    """GPT-base bf16 (flash, chunked head) under ``tier`` with an int8
    ``rs_ag`` transport: SA_EAGER eager steps, ``train_steps`` of SA_WINDOW
    one-step windows (the second replayed) and SA_REPLAYS timed one-window
    replays, on a (data=1, seq=1) mesh with ``shard_seq_dim=1``
    (``mesh``) or on the 1-D data mesh: losses, masters' digest, launches,
    windows captured, step ms and the run's peak rise."""
    from stoke_tpu_torch.configs import (
        CommConfig,
        DataParallelConfig,
        MeshConfig,
    )
    from stoke_tpu_torch.ops.chunked_ce import chunked_causal_lm_loss

    configs = [CommConfig(dtype="int8", strategy="rs_ag")]
    if mesh:
        configs += [MeshConfig(axes=("data", "seq"), shape=(1, 1)),
                    DataParallelConfig(shard_seq_dim=1)]
    before = dict(ops.LAUNCHES)
    start = peak_start() if device == "cuda" else 0
    s = stoke_for(gpt_base("flash", layers=layers, chunked_head=True,
                           device=device), "bf16", batch,
                  loss=chunked_causal_lm_loss, seed=SEED, configs=configs,
                  distributed="dp", device=device, **DP_TIERS[tier])
    losses, ms = eager_steps(s, [batches[i] for i in range(SA_EAGER)])
    seg = batches[SA_EAGER:SA_EAGER + SA_WINDOW]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    one = batches[-1:]
    replay_ms = [timed_ms(lambda: s.train_steps(one, one))
                 for _ in range(SA_REPLAYS)]
    out = {"losses": losses, "digest": masters_digest(s),
           "launches": {n: ops.LAUNCHES[n] - before[n]
                        for n in (*FLASH, *QUANT_NAMES)},
           "windows_captured": len(s._engine._windows),
           "eager_ms": ms, "replay_ms": replay_ms,
           "comm_bytes": s.comm_bytes,
           "residual": [r.numel() for r in
                        s._engine.comm_state.get("residual", [])],
           **(peaks(start) if device == "cuda" else {})}
    s.close_telemetry()
    del s
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def sa_model_stoke(root: str, device="cuda", layers=N_LAYERS,
                   batch=TRAIN_BATCH):
    """GPT-base bf16 under ``gpt_tensor_parallel_rules`` on a (data=1,
    model=1) mesh with fsdp, an int8 transport, the sharded format and a
    ``ResilienceConfig`` under ``root`` (whose emergency tags carry the
    transport's residual and key)."""
    from stoke_tpu_torch.configs import (
        CheckpointConfig,
        CheckpointFormat,
        CommConfig,
        MeshConfig,
        PartitionRulesConfig,
        ResilienceConfig,
    )
    from stoke_tpu_torch.models import gpt_tensor_parallel_rules

    return stoke_for(
        gpt_base("flash", layers=layers, device=device), "bf16", batch,
        seed=SEED, distributed="dp", fsdp=True, device=device,
        configs=[MeshConfig(axes=("data", "model"), shape=(1, 1)),
                 PartitionRulesConfig(rules=gpt_tensor_parallel_rules()),
                 CommConfig(dtype="int8"),
                 CheckpointConfig(format=CheckpointFormat.sharded),
                 ResilienceConfig(save_path=root, exit_on_preempt=False)])


def sa_format(ops, root: str, batches, device="cuda", layers=N_LAYERS,
              batch=TRAIN_BATCH) -> dict:
    """The model mesh's fsdp run with the sharded format: SA_EAGER steps
    uninterrupted, against SA_SPLIT steps, an emergency save (sharded),
    a fresh ``Stoke`` that resumes it, and the remaining steps: losses and
    masters bit for bit; the tag's bytes, save and load ms."""
    n = SA_EAGER
    ref = sa_model_stoke(os.path.join(root, "ref"), device, layers, batch)
    ref_losses, _ = eager_steps(ref, [batches[i] for i in range(n)])
    ref_digest = masters_digest(ref)
    split = sorted({k.split(".")[-2] + "." + k.split(".")[-1]
                    for k in ref.tensor_parallel.cuts})
    ref.close_telemetry()
    del ref
    before = dict(ops.LAUNCHES)
    s = sa_model_stoke(os.path.join(root, "cut"), device, layers, batch)
    losses, _ = eager_steps(s, [batches[i] for i in range(SA_SPLIT)])
    t0 = time.perf_counter()
    tag = s._emergency_save()
    save_ms = (time.perf_counter() - t0) * 1e3
    s.close_telemetry()
    del s
    tag_bytes = sum(os.path.getsize(os.path.join(tag, f))
                    for f in os.listdir(tag))
    with open(os.path.join(tag, "meta.json")) as f:
        meta = json.load(f)
    fresh = sa_model_stoke(os.path.join(root, "cut"), device, layers, batch)
    t0 = time.perf_counter()
    resumed = fresh.resume()
    load_ms = (time.perf_counter() - t0) * 1e3
    more, _ = eager_steps(fresh, [batches[i] for i in range(SA_SPLIT, n)])
    losses += more
    out = {"losses": losses, "reference_losses": ref_losses,
           "digest": masters_digest(fresh), "reference_digest": ref_digest,
           "resumed": resumed, "split": split,
           "launches": {k: ops.LAUNCHES[k] - before[k]
                        for k in (*FLASH, *QUANT_NAMES)},
           "tag_bytes": tag_bytes, "save_ms": save_ms, "load_ms": load_ms,
           "files": sorted(os.listdir(tag)),
           "layout_mesh": meta.get("mesh"),
           "cut_leaves": sum(1 for leaves in meta.get("leaves", {}).values()
                             for leaf in leaves.values() if "cut" in leaf)}
    fresh.close_telemetry()
    return out


def sa_chunked(dtype, device="cuda", B=TRAIN_BATCH, L=TRAIN_LEN, H=768,
               V=VOCAB) -> dict:
    """GPT's chunked head over S virtual sequence shards in one process
    (``chunked_shard_terms``: each shard's sum over its positions against
    the whole sequence's next tokens, summed over the shards, over the
    summed count) against the unsharded chunked loss, at GPT-base's
    hidden ``[B, L, H]`` and its 50257-row embedding: the loss and the
    gradients of the hidden states and of the embedding. fp32 within
    SA_CE_RTOL of each tensor's largest magnitude; under the bf16 policy
    (``compute_dtype``) the gradients' rows within BWD_ROW_RTOL_BF16."""
    from stoke_tpu_torch.ops.attention import SeqShard
    from stoke_tpu_torch.ops.chunked_ce import (
        chunked_causal_lm_loss,
        chunked_shard_terms,
        compute_dtype,
    )

    fa = importlib.import_module("stoke_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=device).manual_seed(SEED)
    hidden = torch.randn(B, L, H, generator=g, device=device)
    emb = 0.02 * torch.randn(V, H, generator=g, device=device)
    ids = torch.randint(0, V, (B, L), generator=g, device=device)
    if dtype == BF16:
        # the policy's fp32 copies of 16-bit values
        hidden, emb = hidden.to(BF16).float(), emb.to(BF16).float()
    policy = dtype if dtype == BF16 else None

    def run(S):
        h = hidden.clone().requires_grad_()
        e = emb.clone().requires_grad_()
        with compute_dtype(policy):
            if S is None:
                loss = chunked_causal_lm_loss((h, e), ids)
            else:
                Ls = L // S
                terms = [chunked_shard_terms(
                    h[:, r * Ls:(r + 1) * Ls], e, ids, None,
                    SeqShard(None, r, S)) for r in range(S)]
                loss = (sum(t for t, _ in terms)
                        / sum(c for _, c in terms).clamp_min(1.0))
        loss.backward()
        return loss.detach(), h.grad, e.grad

    def err(a, b):
        if dtype == FP32:
            return float((a - b).abs().max() / b.abs().max())
        return fa.bwd_row_err(a.reshape(-1, a.shape[-1]),
                              b.reshape(-1, b.shape[-1]))

    ref = run(None)
    out = []
    for S in SA_SHARDS:
        got = run(S)
        loss_err = float((got[0] - ref[0]).abs() / ref[0].abs())
        errs = {"dh": err(got[1], ref[1]), "de": err(got[2], ref[2])}
        limit = SA_CE_RTOL if dtype == FP32 else fa.BWD_ROW_RTOL_BF16
        out.append({"S": S, "dtype": str(dtype).split(".")[-1],
                    "loss": float(got[0]), "loss_rel_err": loss_err,
                    "grad_err": errs, "limit": limit,
                    "ok": loss_err <= SA_CE_RTOL
                    and all(v <= limit for v in errs.values())})
    return {"unsharded_loss": float(ref[0]), "cases": out}


class _VirtualSplit:
    """The model split's collectives over T virtual ranks in one process:
    ``gather`` joins the ranks' slices of a parameter (each rank's
    gradient, registered by ``slices``), ``take`` cuts rank ``rank``'s."""

    def __init__(self, cuts, rank: int, slices):
        self.cuts, self.rank, self._slices = cuts, rank, slices

    def gather(self, name, t):
        return self.cuts[name].join(self._slices[name])

    def take(self, name, whole):
        return self.cuts[name].take(whole, self.rank)


def sa_transport_layout(ops, device="cuda", layers=N_LAYERS) -> dict:
    """GPT-base split over SA_TP virtual model ranks by the Megatron
    rules: each rank's JAX-layout leaves (``JaxLeafOrder`` with the split:
    its slices joined with the other ranks', in the JAX layout and order)
    packed into the int8 transport's buckets, against the unsplit model's,
    bit for bit; the quantize kernel's payload and scales on both, bit
    for bit; and each rank's slices taken back from the whole leaves."""
    import copy

    import torch.nn.functional as F

    from stoke_tpu_torch.configs import CommConfig, ShardingOptions
    from stoke_tpu_torch.models import gpt_tensor_parallel_rules
    from stoke_tpu_torch.parallel import ModelGroup, shard_module
    from stoke_tpu_torch.parallel.collectives import JaxLeafOrder
    from stoke_tpu_torch.parallel.zero import make_transport

    whole = gpt_base("flash", layers=layers, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    grads = {n: torch.randn(p.shape, generator=g, device=device)
             for n, p in whole.named_parameters()}
    params = list(whole.parameters())
    names = [n for n, _ in whole.named_parameters()]
    transport = make_transport(CommConfig(dtype="int8"),
                               ShardingOptions.none)
    cfg = transport.cfg
    key = torch.tensor([0, SEED], dtype=torch.int64, device=device)

    def buckets(order, tensors):
        leaves = order.to_jax(tensors)
        layout = transport._layout(order.sizes())
        out = []
        for idx, elems, padded in layout.buckets:
            flat = torch.cat([leaves[i].reshape(-1).float() for i in idx])
            out.append(F.pad(flat, (0, padded - elems)))
        return out, leaves

    ref, ref_leaves = buckets(JaxLeafOrder(whole, params),
                              [grads[n] for n in names])
    ranks = []
    for r in range(SA_TP):
        m = copy.deepcopy(whole)
        ranks.append((m, shard_module(m, gpt_tensor_parallel_rules(),
                                      ModelGroup(None, SA_TP, r, "model"))))
    cuts = ranks[0][1].cuts
    slices = {n: [cut.take(grads[n], r) for r in range(SA_TP)]
              for n, cut in cuts.items()}
    same, quant_same, back = True, True, True
    before = ops.LAUNCHES["quantize_chunks"]
    ref_q = [sa_quantize(ops, b, cfg, key, i) for i, b in enumerate(ref)]
    for r, (m, tp) in enumerate(ranks):
        mine = [tp.cuts[n].take(grads[n], r) if n in tp.cuts else grads[n]
                for n, _ in m.named_parameters()]
        order = JaxLeafOrder(m, list(m.parameters()),
                             _VirtualSplit(cuts, r, slices))
        got, leaves = buckets(order, mine)
        same &= all(torch.equal(a, b) for a, b in zip(got, ref))
        for i, b in enumerate(got):
            q, s = sa_quantize(ops, b, cfg, key, i)
            quant_same &= (torch.equal(q, ref_q[i][0])
                           and torch.equal(s, ref_q[i][1]))
        into = [torch.empty_like(t) for t in mine]
        order.from_jax(leaves, into)
        back &= all(torch.equal(a, b) for a, b in zip(into, mine))
    return {"T": SA_TP, "buckets": len(ref),
            "elements": int(sum(b.numel() for b in ref)),
            "split": sorted(cuts), "buckets_equal": bool(same),
            "quantized_equal": bool(quant_same),
            "slices_back": bool(back),
            "quantize_launches": ops.LAUNCHES["quantize_chunks"] - before,
            "ok": bool(same and quant_same and back)}


def sa_quantize(ops, flat, cfg, key, bucket: int):
    """The transport's int8 quantize of bucket ``bucket`` (its
    ``fold_in``)."""
    return ops.quantize_chunks(flat, cfg.chunk_elems, key,
                               cfg.stochastic_rounding, (bucket,))


def train_second_axis(ops, device="cuda", layers=N_LAYERS,
                      batch=TRAIN_BATCH) -> dict:
    """The tiers, the transports, the sharded format and the chunked head
    under a second mesh axis on the card, at world 1 (every mesh (1, 1)):
    (a) GPT-base bf16 with the chunked head under oss, sddp and fsdp, each
    with an int8 rs_ag transport, on a (data=1, seq=1) mesh with
    ``shard_seq_dim=1`` against the same tier on the 1-D data mesh
    (:func:`sa_run`): losses and masters bit for bit, a window captured,
    the flash and quantize pair launched; (b) the model mesh's fsdp run
    with the sharded format resumed after SA_SPLIT steps
    (:func:`sa_format`) bit for bit; (c) the chunked head over S = 2 and 4
    virtual sequence shards (:func:`sa_chunked`) and the transport's
    layout over SA_TP virtual model ranks (:func:`sa_transport_layout`) at
    GPT-base's widths."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    batches = window_batches(SA_EAGER + SA_WINDOW)
    if batch != TRAIN_BATCH or device != "cuda":
        batches = batches[:, :batch, :128].to(device)
    failures = []
    runs = {}
    root = tempfile.mkdtemp(prefix="stoke-second-axis-")
    try:
        for tier in SA_TIERS:
            for mesh in (False, True):
                runs[f"{tier}_{'seq' if mesh else 'data'}"] = sa_run(
                    ops, mesh, tier, batches, device, layers, batch)
        fmt = sa_format(ops, root, batches, device, layers, batch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    for tier in SA_TIERS:
        a, b = runs[f"{tier}_seq"], runs[f"{tier}_data"]
        for key in ("losses", "digest", "launches", "windows_captured",
                    "comm_bytes", "residual"):
            if a[key] != b[key]:
                failures.append(f"{tier} seq vs data {key}: {a[key]} vs "
                                f"{b[key]}")
        # on the card (the CPU runs a window eagerly)
        if device == "cuda" and a["windows_captured"] < 1:
            failures.append(f"{tier}: no window captured")
        if device == "cuda" and not all(a["launches"].values()):
            failures.append(f"{tier}: launches {a['launches']}")
    if (fmt["losses"] != fmt["reference_losses"]
            or fmt["digest"] != fmt["reference_digest"]
            or not fmt["resumed"] or not fmt["split"]
            or not fmt["cut_leaves"]):
        failures.append(f"sharded format: {fmt}")
    virtual = {"chunked": {str(dt).split(".")[-1]: sa_chunked(dt, device)
                           for dt in (FP32, BF16)},
               "transport_layout": sa_transport_layout(ops, device, layers)}
    for dt, v in virtual["chunked"].items():
        for c in v["cases"]:
            if not c["ok"]:
                failures.append(f"virtual chunked head {dt}: {c}")
    if not virtual["transport_layout"]["ok"]:
        failures.append(f"transport layout: {virtual['transport_layout']}")
    if failures:
        raise AssertionError("train_second_axis: " + "; ".join(failures))

    def p50(xs):
        return float(np.median(xs)) if xs else None

    seq = {k: v for k, v in runs.items() if k.endswith("_seq")}
    return {
        "phase": "train_second_axis",
        "model": "GPT-base bf16 (flash, chunked head), B=8, L=1024, AdamW, "
                 "clip 1.0, int8 rs_ag transport; every mesh (1, 1)",
        "bit_for_bit": True,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "launches": {k: v["launches"] for k, v in runs.items()},
        "windows_captured": {k: v["windows_captured"] for k, v in
                             seq.items()},
        "eager_ms_p50": {k: p50(v["eager_ms"][1:]) for k, v in runs.items()},
        "replay_ms_p50": {k: p50(v["replay_ms"]) for k, v in runs.items()},
        "eager_ms": {k: v["eager_ms"] for k, v in runs.items()},
        "replay_ms": {k: v["replay_ms"] for k, v in runs.items()},
        "peak_gb": {k: v.get("peak_gb") for k, v in runs.items()},
        "process_peak_gb": {k: v.get("process_peak_gb")
                            for k, v in runs.items()},
        "comm_bytes": runs["fsdp_seq"]["comm_bytes"],
        "sharded_format": fmt,
        "virtual": virtual,
        "launches_total": {n: sum(v["launches"][n] for v in runs.values())
                           + fmt["launches"][n]
                           for n in (*FLASH, *QUANT_NAMES)},
        "seconds": time.perf_counter() - t0,
    }


TA_EAGER = 3              # eager steps of the main path, then a window
TA_WINDOW = 2             # one-step windows (the second replayed)
TA_REPLAYS = 2            # timed one-window replays
TA_LAYERS = 2             # the depth of the smaller runs (seq, stage, gathered)
TA_SPLITS = (2, 2)        # the virtual (model, expert) ranks of one block
#: ln_attn's scale on the model axis and ff_in's kernel over the flattened
#: (model, expert) axes: two gathered placements
TA_GATHERED_RULES = ((r"ln_attn/scale", ("model",)),
                     (r"ff_in/kernel", (None, ("model", "expert"))))
#: PipelinedLM's qkv kernels also on the model axis, ahead of the stage set
TA_STAGE_QKV_RULE = ((r"^stages/.*attention/qkv/kernel",
                      ("stage", None, None, "model", None)),)


def ta_moe_stoke(mesh: bool, root: str):
    """GPT-base-MoE top-1 bf16 (flash) under fsdp with an int8 ``rs_ag``
    transport, AdamW without a clip (the clip's norm sums the leaves a
    rule keeps whole apart from the fsdp slices, in another order than
    the 1-D run), a ``ResilienceConfig`` under ``root`` and the sharded
    format: on a (1, 1, 1) ``("data", "model", "expert")`` mesh with the
    Megatron and expert rules (``mesh``), or on the 1-D data mesh."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import (
        CheckpointConfig,
        CheckpointFormat,
        CommConfig,
        FSDPConfig,
        MeshConfig,
        PartitionRulesConfig,
        ResilienceConfig,
    )
    from stoke_tpu_torch.models import (
        bert_tensor_parallel_rules,
        causal_lm_loss,
        moe_expert_parallel_rules,
    )

    configs = [CommConfig(dtype="int8", strategy="rs_ag"), FSDPConfig(),
               CheckpointConfig(format=CheckpointFormat.sharded),
               ResilienceConfig(save_path=root, exit_on_preempt=False,
                                manifest=False)]
    if mesh:
        configs += [MeshConfig(axes=("data", "model", "expert"),
                               shape=(1, 1, 1)),
                    PartitionRulesConfig(rules=bert_tensor_parallel_rules()
                                         + moe_expert_parallel_rules())]
    return Stoke(moe_base(1), StokeOptimizer(torch.optim.AdamW, lr=3e-4,
                                             weight_decay=1e-4),
                 causal_lm_loss, batch_size_per_device=TRAIN_BATCH,
                 precision="bf16", seed=SEED, distributed="dp", fsdp=True,
                 configs=configs)


def ta_main(ops, mesh: bool, batches, root: str) -> dict:
    """The main path (:func:`ta_moe_stoke`): TA_EAGER eager steps, a
    ``train_steps`` of TA_WINDOW one-step windows and TA_REPLAYS timed
    one-window replays; losses, masters' digest, the flash and quantize
    launches (reset just before the run, read just after), ``comm_bytes``
    and the run's peak rise. On the mesh, then an emergency save in the
    sharded format, a fresh ``Stoke`` that resumes it, and one more step
    of both: loss and masters bit for bit."""
    names = (*FLASH, *QUANT_NAMES)
    ops.reset_launches()
    start = peak_start()
    s = ta_moe_stoke(mesh, root)
    losses, ms = eager_steps(s, [batches[i] for i in range(TA_EAGER)])
    seg = batches[TA_EAGER:TA_EAGER + TA_WINDOW]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    one = batches[-1:]
    replay_ms = [timed_ms(lambda: s.train_steps(one, one))
                 for _ in range(TA_REPLAYS)]
    out = {"losses": losses, "digest": masters_digest(s),
           "launches": {n: ops.LAUNCHES[n] for n in names},
           "windows_captured": len(s._engine._windows),
           "eager_ms": ms, "replay_ms": replay_ms,
           "comm_bytes": s.comm_bytes, **peaks(start),
           "split": None if s.tensor_parallel is None else sorted(
               {".".join(n.split(".")[-2:]) for n in
                s.tensor_parallel.cuts})}
    if mesh:
        t0 = time.perf_counter()
        tag = s._emergency_save()
        save_ms = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(tag, "meta.json")) as f:
            meta = json.load(f)
        fresh = ta_moe_stoke(True, root)
        t0 = time.perf_counter()
        resumed = fresh.resume()
        load_ms = (time.perf_counter() - t0) * 1e3
        nxt = batches[:1]
        after = [[float(t.train_step(nxt[0], nxt[0])), masters_digest(t)]
                 for t in (s, fresh)]
        out["sharded_format"] = {
            "resumed": resumed, "next_step": after,
            "bit_for_bit": after[0] == after[1],
            "tag_bytes": sum(os.path.getsize(os.path.join(tag, f))
                             for f in os.listdir(tag)),
            "save_ms": save_ms, "load_ms": load_ms,
            "layout_mesh": meta.get("mesh"),
            "cut_axes": sorted({tuple(leaf["cut"]["axes"])
                                for leaves in meta["leaves"].values()
                                for leaf in leaves.values()
                                if "cut" in leaf})}
        fresh.close_telemetry()
        del fresh
    s.close_telemetry()
    del s
    torch.cuda.empty_cache()
    return out


def ta_small(ops, kind: str, mesh: bool, batches) -> dict:
    """A TA_LAYERS-block run of ``kind`` (bf16, clip 1.0; TA_EAGER eager
    steps, then a ``train_steps`` of TA_WINDOW one-step windows, the
    second replayed: a gathered placement's all-gather is captured with
    the window): ``"seq"`` GPT-base with ring attention under the Megatron
    rules on a (1, 1, 1) ``("data", "seq", "model")`` mesh with
    ``shard_seq_dim=1``; ``"stage"`` PipelinedLM (GPipe) under the stage
    set with the qkv kernels also on ``model`` on ``("data", "stage",
    "model")``, against the stage set alone on ``("data", "stage")``;
    ``"gathered"`` GPT-base under TA_GATHERED_RULES on ``("data",
    "model", "expert")``. Without ``mesh``: the same model without the
    mesh (the stage run: on its two-axis mesh)."""
    from stoke_tpu_torch.configs import (
        DataParallelConfig,
        MeshConfig,
        PartitionRulesConfig,
    )
    from stoke_tpu_torch.models import (
        bert_tensor_parallel_rules,
        pipeline_parallel_rules,
    )
    from stoke_tpu_torch.ops import attention as sp

    flags = {}
    if kind == "stage":
        model = pipelined_lm(layers_per_stage=TA_LAYERS)
        axes = ("data", "stage", "model") if mesh else ("data", "stage")
        rules = ((TA_STAGE_QKV_RULE if mesh else ())
                 + pipeline_parallel_rules())
        flags = dict(distributed="dp", configs=[
            MeshConfig(axes=axes, shape=(1,) * len(axes)),
            PartitionRulesConfig(rules=rules)])
    else:
        model = gpt_base("flash", layers=TA_LAYERS)
        if kind == "seq":
            for block in model.layers:
                block.attention.attention_fn = sp.make_ring_attention(
                    causal=True)
        if mesh:
            axes = (("data", "seq", "model") if kind == "seq"
                    else ("data", "model", "expert"))
            rules = (bert_tensor_parallel_rules() if kind == "seq"
                     else TA_GATHERED_RULES)
            configs = [MeshConfig(axes=axes, shape=(1, 1, 1)),
                       PartitionRulesConfig(rules=rules)]
            if kind == "seq":
                configs.append(DataParallelConfig(shard_seq_dim=1))
            flags = dict(distributed="dp", configs=configs)
    before = dict(ops.LAUNCHES)
    s = stoke_for(model, "bf16", TRAIN_BATCH, seed=SEED, **flags)
    losses, ms = eager_steps(s, [batches[i] for i in range(TA_EAGER)])
    seg = batches[TA_EAGER:TA_EAGER + TA_WINDOW]
    losses += [float(v) for v in s.train_steps(seg, seg).reshape(-1)]
    tp = s.tensor_parallel
    out = {"losses": losses, "digest": masters_digest(s),
           "launches": flash_delta(ops, before), "eager_ms": ms,
           "windows_captured": len(s._engine._windows),
           # the cut leaves by the axes their slices lie over
           "cuts": None if tp is None else dict(collections.Counter(
               "/".join(c.group_axes) for c in tp.cuts.values())),
           "gathered": None if tp is None else len(tp.gathered)}
    s.close_telemetry()
    del s
    torch.cuda.empty_cache()
    return out


def virtual_model_expert(ops, dtype) -> dict:
    """One GPT-base-MoE block (flash attention, causal; 8 experts,
    capacity 1.25, top-1) under the Megatron and expert rules over
    TA_SPLITS virtual (model, expert) ranks by the port's own cut
    (``shard_module`` with one virtual group a mesh axis): the attention's
    partial sums over the model ranks at 12 / T heads, the experts'
    outputs over the expert ranks at 8 / X experts, gathered here in place
    of the collectives. In fp32 the whole block, forward and every
    gradient, against the unsplit block within PARITY_RTOL. In bf16 each
    region against the unsplit block's region on the same input, in
    :func:`split_errors`'s row check: the attention sublayer against the
    unsplit bf16 and fp32 blocks, the MoE sublayer against the unsplit
    bf16 block (a bf16 input that differs by one rounding can route a
    near tie to another expert, as :func:`virtual_ep` notes)."""
    import copy

    from stoke_tpu_torch.models import (
        MoEFFN,
        bert_tensor_parallel_rules,
        moe_expert_parallel_rules,
    )
    from stoke_tpu_torch.models.moe import MoETransformerBlock
    from stoke_tpu_torch.ops import make_flash_attention
    from stoke_tpu_torch.parallel import ModelGroup, shard_module

    T, X = TA_SPLITS
    H = HEADS * HEAD_DIM
    torch.manual_seed(SEED + 7)
    whole = MoETransformerBlock(
        H, HEADS, 4 * H, MOE_EXPERTS, 0.0, MOE_CAPACITY,
        make_flash_attention(causal=True), top_k=1,
        device="cuda").to(dtype)
    base = copy.deepcopy(whole)
    ranks, tps = {}, {}
    for m in range(T):
        for e in range(X):
            b = copy.deepcopy(base)
            tps[(m, e)] = shard_module(
                b, bert_tensor_parallel_rules() + moe_expert_parallel_rules(),
                {"model": ModelGroup(None, T, m, "model"),
                 "expert": ModelGroup(None, X, e, "expert")})
            ranks[(m, e)] = b
    model_ranks = [ranks[(m, 0)] for m in range(T)]
    expert_ranks = [ranks[(0, e)] for e in range(X)]
    n = MOE_EXPERTS // X

    def attention(xs):
        a = sum(b.attention.partial(xs, None) for b in model_ranks)
        return base.ln_attn(xs + a + base.attention.out.bias)

    def moe(h):
        slot, gates = base.moe.route(h)
        ein = base.moe.dispatch(h, slot)
        outs = [b.moe.experts(ein[e * n:(e + 1) * n])
                for e, b in enumerate(expert_ranks)]
        return base.ln_ff(h + MoEFFN.combine(torch.cat(outs), slot, gates))

    def grads_of(xs):
        out = {}
        for name, p in base.named_parameters():
            tp = tps[(0, 0)]
            cut = tp.cuts.get(name)
            if cut is None:
                g = p.grad
            else:
                group = (model_ranks if cut.group_axes == ("model",)
                         else expert_ranks)
                parts = [dict(b.named_parameters())[name].grad
                         for b in group]
                g = None if parts[0] is None else cut.join(parts)
            if g is not None:
                out[name] = g
        out["x"] = xs.grad
        return out

    def zero():
        for b in (base, *ranks.values()):
            b.zero_grad(set_to_none=True)

    def pick(ref):
        out, grads = ref
        return out, {k: v for k, v in grads.items() if v is not None}

    x = torch.randn(TRAIN_BATCH, TRAIN_LEN, H, device="cuda", dtype=dtype)
    dout = torch.randn_like(x)
    before = dict(ops.LAUNCHES)
    regions = {}
    if dtype == FP32:
        refs = [pick(block_pass(whole, x, dout, lambda m, t: m(t, None)))]
        xs = x.clone().requires_grad_()
        out = moe(attention(xs))
        out.backward(dout)
        regions["block"] = split_errors((out.detach(), grads_of(xs)), refs,
                                        dtype)
    else:
        whole32 = copy.deepcopy(whole).float()

        def sub_attn(m, t):
            return m.ln_attn(t + m.attention(t, None))

        refs = [pick(block_pass(whole, x, dout, sub_attn)),
                pick(block_pass(whole32, x.float(), dout.float(), sub_attn))]
        xs = x.clone().requires_grad_()
        out = attention(xs)
        out.backward(dout)
        regions["attention"] = split_errors((out.detach(), grads_of(xs)),
                                            refs, dtype)
        zero()
        whole.zero_grad(set_to_none=True)
        refs = [pick(block_pass(whole, x, dout,
                                lambda m, t: m.ln_ff(t + m.moe(t))))]
        xs = x.clone().requires_grad_()
        out = moe(xs)
        out.backward(dout)
        regions["moe"] = split_errors((out.detach(), grads_of(xs)), refs,
                                      dtype)
    launches = flash_delta(ops, before)
    return {"T": T, "X": X, "dtype": str(dtype).replace("torch.", ""),
            "heads_a_rank": model_ranks[0].attention.local_heads,
            "experts_a_rank": expert_ranks[0].moe.local_experts,
            "regions": regions, "launches": launches,
            "ok": all(r["ok"] for r in regions.values())
            and all(v > 0 for v in launches.values())}


def train_three_axes(ops) -> dict:
    """Meshes of three axes on the card, at world 1 (every mesh of ones):
    (1) the main path, GPT-base-MoE top-1 bf16 under the Megatron and
    expert rules on a (1, 1, 1) ``("data", "model", "expert")`` mesh with
    fsdp and the int8 rs_ag transport, against the same run on the 1-D
    data mesh (:func:`ta_main`): losses, masters, the flash and quantize
    launches and ``comm_bytes`` bit for bit, eager and replayed; (2) its
    emergency save in the sharded format, resumed bit for bit; (3)-(5)
    GPT-base under ``("data", "seq", "model")``, PipelinedLM under
    ``("data", "stage", "model")`` with a gathered qkv level, GPT-base
    with two gathered placements, each TA_LAYERS blocks deep, bit for
    bit against the run without the third axis (:func:`ta_small`); (6)
    one GPT-base-MoE block over TA_SPLITS virtual (model, expert) ranks
    (:func:`virtual_model_expert`)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    batches = window_batches(TA_EAGER + TA_WINDOW)
    failures = []
    runs, small = {}, {}
    root = tempfile.mkdtemp(prefix="stoke-three-axes-")
    try:
        for mesh in (True, False):
            runs["mesh" if mesh else "data"] = ta_main(
                ops, mesh, batches, os.path.join(root, str(mesh)))
        for kind in ("seq", "stage", "gathered"):
            for mesh in (True, False):
                small[f"{kind}_{'mesh' if mesh else 'plain'}"] = ta_small(
                    ops, kind, mesh, batches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    a, b = runs["mesh"], runs["data"]
    for key in ("losses", "digest", "launches", "windows_captured",
                "comm_bytes"):
        if a[key] != b[key]:
            failures.append(f"main path mesh vs data {key}: {a[key]} vs "
                            f"{b[key]}")
    if not all(a["launches"].values()):
        failures.append(f"main path launches {a['launches']}")
    if a["windows_captured"] < 1:
        failures.append("main path: no window captured")
    if not a["split"]:
        failures.append("main path: nothing split")
    fmt = a["sharded_format"]
    if not (fmt["resumed"] and fmt["bit_for_bit"]):
        failures.append(f"sharded format: {fmt}")
    for kind in ("seq", "stage", "gathered"):
        m, p = small[f"{kind}_mesh"], small[f"{kind}_plain"]
        for key in ("losses", "digest", "launches", "windows_captured"):
            if m[key] != p[key]:
                failures.append(f"{kind} {key}: {m[key]} vs {p[key]}")
        if not m["cuts"]:
            failures.append(f"{kind}: nothing cut")
        if m["windows_captured"] < 1:
            failures.append(f"{kind}: no window captured")
    if not small["stage_mesh"]["gathered"] or not small[
            "gathered_mesh"]["gathered"]:
        failures.append("no gathered placement")
    virtual = [virtual_model_expert(ops, dt) for dt in (FP32, BF16)]
    for v in virtual:
        if not v["ok"]:
            failures.append(f"virtual (model, expert) block: {v}")
    if failures:
        raise AssertionError("train_three_axes: " + "; ".join(failures))

    def p50(xs):
        return float(np.median(xs)) if xs else None

    return {
        "phase": "train_three_axes",
        "model": "GPT-base-MoE (8 experts every 2nd block, capacity 1.25, "
                 "top-1) bf16, flash, B=8, L=1024, AdamW, fsdp, int8 rs_ag; "
                 f"seq / stage / gathered runs GPT-base or PipelinedLM at "
                 f"{TA_LAYERS} blocks, clip 1.0; every mesh of ones",
        "bit_for_bit": True,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "launches": {k: v["launches"] for k, v in runs.items()},
        "windows_captured": {k: v["windows_captured"]
                             for k, v in runs.items()},
        "eager_ms_p50": {k: p50(v["eager_ms"][1:]) for k, v in runs.items()},
        "replay_ms_p50": {k: p50(v["replay_ms"]) for k, v in runs.items()},
        "eager_ms": {k: v["eager_ms"] for k, v in runs.items()},
        "replay_ms": {k: v["replay_ms"] for k, v in runs.items()},
        "peak_gb": {k: v["peak_gb"] for k, v in runs.items()},
        "process_peak_gb": {k: v["process_peak_gb"]
                            for k, v in runs.items()},
        "comm_bytes": a["comm_bytes"],
        "split": a["split"],
        "sharded_format": fmt,
        "small": {k: {kk: v[kk] for kk in ("losses", "launches", "cuts",
                                           "gathered", "eager_ms",
                                           "windows_captured")}
                  for k, v in small.items()},
        "virtual": virtual,
        "launches_main": a["launches"],
        "launches_total": {n: sum(v["launches"].get(n, 0)
                                  for v in (*runs.values(),
                                            *small.values(), *virtual))
                           for n in (*FLASH, *QUANT_NAMES)},
        "seconds": time.perf_counter() - t0,
    }


def quant_rows(cases, comm, served, elastic, second, third) -> list:
    """The kernels line's rows of the quantize pair: ``ms`` and its
    bound at the 25 MB bucket (stochastic, chunk 512), the case the
    transports launch; every case beside it; launches from train_comm
    (the quantize) and from train_comm and serve_quant (the
    dequantize), and, beside, the elastic resume's steps (``elastic``),
    train_second_axis's runs (``second``) and train_three_axes's main
    path (``third``)."""
    main_case = next(c for c in cases if c["n"] == QUANT_BUCKET
                     and c["chunk"] == 512 and c["stochastic"])
    rows = []
    for name, key, fn, line in (
            ("quantize_chunks", "quantize", "quantize_chunks_kernel", 61),
            ("dequantize_chunks", "dequantize",
             "dequantize_chunks_kernel", 91)):
        c = main_case[key]
        row = {"name": name, "route": "cuda",
               "source": "stoke_tpu_torch/csrc/quant.cu",
               "functions": [fn],
               "replaces": f"stoke_tpu/parallel/collectives.py:{line}",
               "launches": comm["launches"][name]
               + served["launches"].get(name, 0),
               "launches_train_comm": comm["launches"][name],
               "launches_serve_quant": served["launches"].get(name, 0),
               "launches_train_resilience": elastic[name],
               "launches_train_second_axis": second[name],
               "launches_train_three_axes": third[name],
               "max_abs_err": max(x["max_abs_err"] if key == "dequantize"
                                  else x["quantize_max_abs_err"]
                                  for x in cases),
               "ms": c["ms"], "graph_ms": c["graph_ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "library_ms": None,
               "cases": [{"n": x["n"], "chunk": x["chunk"],
                          "stochastic": x["stochastic"],
                          **{k: x[key][k] for k in
                             ("ms", "graph_ms", "plain_ms", "bound_ms")}}
                         for x in cases]}
        rows.append(row)
    return rows


# --------------------------------------------------------------------------- #
# the compile cache, the program auditor and the autotuner
# --------------------------------------------------------------------------- #

AUDIT_STEPS, AUDIT_REPLAYS = 3, 2  # eager steps, then a window and replays
CACHE_LAYERS = 2  # the cache workers' GPT-base depth (full width)


def cache_worker(argv) -> int:
    """``chip_smoke.py --cache-worker <cache_dir>``: one process of the
    compile cache's cross-process check. GPT-base bf16 (full width,
    CACHE_LAYERS blocks) with ``CompileConfig(cache_dir=<cache_dir>)``:
    one ``train_step`` (its first run loads the flash kernels, which
    builds the five sources into ``<cache_dir>/kernels`` where they are
    missing), one served request; each kernel of the five libraries
    against its plain version at one case (``library_checks``), then the
    cache's stats; then a second ``Stoke`` in the process (2 blocks),
    which must build nothing. Prints one JSON line."""
    from stoke_tpu_torch import configs as pc
    from stoke_tpu_torch import ops
    from stoke_tpu_torch.ops import _build

    t0 = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t0

    cache_dir = argv[0]
    cfg = pc.CompileConfig(cache_dir=cache_dir)
    serve_cfg = pc.ServeConfig(attention="flash", decode_kernel="pallas",
                               **SERVE)
    b = window_batches(1)[0]
    s = stoke_for(gpt_base("flash", layers=CACHE_LAYERS), "bf16",
                  TRAIN_BATCH, configs=[cfg, serve_cfg])
    mark("stoke")
    loss = float(s.train_step(b, b))
    mark("first_step")
    engine = s.serve()
    engine.submit(np.random.default_rng(SEED).integers(0, VOCAB, size=40))
    engine.run()
    mark("serve")
    checks = library_checks(ops)
    mark("checks")
    built = _build.built_seconds()
    stats = s.compile_cache.stats()
    # a second Stoke in this process: the loaded libraries serve it
    s2 = stoke_for(gpt_base("flash", layers=2), "bf16", TRAIN_BATCH,
                   configs=[cfg])
    s2.train_step(b, b)
    mark("second_stoke")
    print(json.dumps({
        "loss": loss, "stats": stats, "built_s": built, "marks_s": marks,
        "second_stoke_built_s": _build.built_seconds() - built,
        "second_stoke_stats": s2.compile_cache.stats(),
        "build_dir": str(_build.build_dir()),
        "libraries": sorted(p.name for p in _build.build_dir().glob("*.so")),
        "checks": checks, "seconds": time.perf_counter() - t0}),
        flush=True)
    return 0


def library_checks(ops) -> dict:
    """Each library the process loaded against its plain version at one
    case, untimed: the bf16 flash forward (``wgmma``) at B=2, H=12,
    L=256; the fp32 flash backward (3xTF32) by autograd against the plain
    attention's; the decode and verify kernels at the serve shapes; the
    quantize pair on one 512-element-chunked bucket, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(2, HEADS, 256, HEAD_DIM, generator=gen,
                           device="cuda") for _ in range(3))
    qb, kb, vb = (t.to(BF16) for t in (q, k, v))
    fwd = max_err(ops.flash_attention(qb, kb, vb, None, causal=True),
                  ops.flash_attention_plain(qb, kb, vb, None, True)[0])
    grads = []
    for attend in (lambda *a: ops.flash_attention(*a, None, causal=True),
                   lambda *a: ops.flash_attention_plain(*a, None, True)[0]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attend(*leaves).square().sum().backward()
        grads.append([t.grad for t in leaves])
    bwd = max(max_err(a, b) for a, b in zip(*grads))
    out = {"flash_fwd": fwd, "flash_bwd": bwd,
           "paged_decode": paged_case(ops, gen, "decode"),
           "paged_verify": paged_case(ops, gen, "verify")}
    if fwd > ops.FWD_ATOL_BF16 or bwd > FP32_ATOL:
        raise AssertionError(f"flash libraries: {out}")
    out["quant"] = quant_case(ops, gen, torch.empty(1, device="cuda"),
                              QUANT_BUCKET // 8, 512, True)["max_abs_err"]
    return out


def paged_case(ops, gen, kind: str) -> float:
    """The decode (``DECODE_CASES``' first shape) or verify
    (``VERIFY_CASES``' first) kernels against the plain version, fp32
    pool; returns the largest difference, raising past the tolerance."""
    if kind == "decode":
        args = decode_inputs(gen, FP32)
        out = ops.paged_decode_attention_pallas(*args)
        ref = ops.paged_decode_attention(*args)
    else:
        args = verify_inputs(gen, FP32)
        out = ops.paged_verify_attention_pallas(*args)
        ref = ops.paged_verify_attention(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not (torch.isfinite(out).all() and err <= FP32_ATOL):
        raise AssertionError(f"paged_{kind}: max |kernel - plain| {err} > "
                             f"{FP32_ATOL}")
    return err


def run_cache_worker(cache_dir: str) -> dict:
    import stoke_tpu_torch

    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(stoke_tpu_torch.__file__)))}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cache-worker",
         cache_dir], capture_output=True, text=True, timeout=300, env=env)
    if out.returncode != 0:
        raise AssertionError(f"cache worker failed (exit {out.returncode}):"
                             f"\n{out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec


def cache_across_processes() -> dict:
    """(a) Two processes on one cache directory: the first builds the
    five sources into ``<dir>/kernels`` inside its first program and
    misses each library; the second builds nothing, hits each and credits
    the first's build seconds."""
    import tempfile

    root = tempfile.mkdtemp(prefix="stoke-compile-cache-")
    try:
        cold = run_cache_worker(root)
        warm = run_cache_worker(root)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    if len(cold["libraries"]) != 5 or not cold["build_dir"].startswith(
            os.path.realpath(root)):
        raise AssertionError(f"the cold process did not build the five "
                             f"sources into the cache: {cold}")
    if (cold["stats"]["misses"], cold["stats"]["hits"]) != (5, 0):
        raise AssertionError(f"cold process: {cold['stats']}")
    if warm["built_s"] != 0.0 or \
            (warm["stats"]["misses"], warm["stats"]["hits"]) != (0, 5):
        raise AssertionError(f"the warm process built {warm['built_s']} s "
                             f"or missed: {warm['stats']}")
    # each library's record holds its share of the cold build call's wall
    saved = warm["stats"]["saved_compile_s"]
    if abs(saved - cold["built_s"]) > 1e-3:
        raise AssertionError(f"warm process credited {saved} s against the "
                             f"cold build's {cold['built_s']} s")
    for run in (cold, warm):
        if run["second_stoke_built_s"] != 0.0:
            raise AssertionError("a second Stoke in the process built "
                                 "kernels")
    if cold["loss"] != warm["loss"]:
        raise AssertionError(f"cold and warm first losses differ: "
                             f"{cold['loss']} {warm['loss']}")
    return {"cold": cold, "warm": warm, "saved_compile_s": saved,
            "cold_build_s": cold["built_s"]}


def cached_training(ops, cache_dir: str) -> dict:
    """(b) GPT-base bf16, AUDIT_STEPS eager ``train_step``s then a window
    and AUDIT_REPLAYS replays (``train_steps`` of one step each), without
    and with ``CompileConfig``: losses, the masters' digest, launches and
    dispatch counts must be equal bit for bit."""
    from stoke_tpu_torch import configs as pc

    batches = window_batches(AUDIT_STEPS + 1 + AUDIT_REPLAYS)
    runs = {}
    for name, extra in (("plain", []),
                        ("cached", [pc.CompileConfig(cache_dir=cache_dir)])):
        t0 = time.perf_counter()
        s = stoke_for(gpt_base("flash"), "bf16", TRAIN_BATCH,
                      configs=extra + [pc.ServeConfig(
                          attention="flash", decode_kernel="pallas",
                          **SERVE)])
        construct_s = time.perf_counter() - t0
        ops.reset_launches()
        eager_ms, losses = [], []
        for b in batches[:AUDIT_STEPS]:
            eager_ms.append(timed_ms(lambda: losses.append(
                s.train_step(b, b))))
        window_ms = []
        for b in batches[AUDIT_STEPS:]:
            window_ms.append(timed_ms(lambda: losses.append(
                s.train_steps(b[None], b[None]))))
        runs[name] = {
            "stoke": s, "losses": [float(l.float().mean()) for l in losses],
            "digest": masters_digest(s), "launches": dict(ops.LAUNCHES),
            "dispatch_count": s.dispatch_count, "construct_s": construct_s,
            "eager_ms": eager_ms, "window_ms": window_ms,
            "first_step_ms": eager_ms[0],
            "eager_p50_ms": float(np.median(eager_ms[1:])),
            "replayed_p50_ms": float(np.median(window_ms[1:])),
        }
    a, b = runs["plain"], runs["cached"]
    for key in ("losses", "digest", "launches", "dispatch_count"):
        if a[key] != b[key]:
            raise AssertionError(f"with and without the cache, {key} differ:"
                                 f" {a[key]} {b[key]}")
    want = N_LAYERS * (AUDIT_STEPS + 1 + AUDIT_REPLAYS)
    flash_launches(ops, want, "compile_audit training")
    return runs


def recording_ms(s, batch) -> dict:
    """What recording a program costs: the engine's micro-step (the bf16
    forward, loss and backward of ``train_step`` without its apply) of the
    warmed build, timed plain and under the recorder, twice each (the
    gradients it leaves are released), and the ops recorded."""
    from stoke_tpu_torch.analysis.program import TraceRecorder

    eng = s._engine
    times = {}
    # the recorder the engines run at a first run: the facts, no text
    for name in ("plain", "recorded", "plain2", "recorded2"):
        rec = TraceRecorder("probe") if name.startswith("recorded") else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rec is None:
            eng.accum((batch,), {}, (batch,))
        else:
            with rec:
                eng.accum((batch,), {}, (batch,))
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if rec is not None:
            times["ops"] = rec.facts.ops
        eng.optimizer.zero_grad(set_to_none=True)
    return {"fwd_bwd_ms": min(times["plain"], times["plain2"]),
            "recorded_fwd_bwd_ms": min(times["recorded"],
                                       times["recorded2"]),
            "recording_extra_ms": min(times["recorded"], times["recorded2"])
            - min(times["plain"], times["plain2"]),
            "recorded_ops": times["ops"]}


def audit_checks(ops, runs) -> dict:
    """(c) ``Stoke.audit()`` of the cached build and its ``serve``
    engine (the serve trace's 16 requests): no findings, and dispatch and
    launch counts equal across it; then a loss that calls ``.item()``
    must fire ``audit-hidden-transfer`` on the card."""
    from stoke_tpu_torch.models.gpt import causal_lm_loss

    s = runs["cached"]["stoke"]
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 401, size=16)
    prompts = [rng.integers(0, VOCAB, size=int(n)) for n in lens]
    t0 = time.perf_counter()
    engine = s.serve()
    build_s = time.perf_counter() - t0
    _, drive_s = drive(engine, prompts)
    before = (s.dispatch_count, dict(ops.LAUNCHES))
    t0 = time.perf_counter()
    rep = s.audit(serve=engine)
    audit_s = time.perf_counter() - t0
    if rep.findings:
        raise AssertionError("the audit found:\n" + rep.format())
    if (s.dispatch_count, dict(ops.LAUNCHES)) != before:
        raise AssertionError("the audit dispatched or launched")

    def item_loss(out, y):
        loss = causal_lm_loss(out, y)
        loss.item()
        return loss

    b = window_batches(1)[0]
    t0 = time.perf_counter()
    probe = stoke_for(gpt_base("flash", layers=2), "bf16", TRAIN_BATCH,
                      loss=item_loss)
    probe.train_step(b, b)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fired = probe.audit()
    rules = sorted({f.rule for f in fired.findings})
    if rules != ["audit-hidden-transfer"]:
        raise AssertionError(f".item() in the loss: {fired.format()}")
    probe_s = time.perf_counter() - t0
    return {"findings": 0, "programs": rep.programs, "notes": rep.notes,
            "audit_s": audit_s, "serve_build_s": build_s,
            "serve_drive_s": drive_s, "item_probe_s": probe_s,
            "item_loss_rules": rules,
            "item_loss_message": fired.findings[0].message[:160],
            "recording": recording_ms(s, b)}


def decode_sweep(ledger: str) -> dict:
    """(d) The ``serve_decode`` workload of ``scripts/autotune_torch.py``
    (its trial measurement, in this process): the paged decode kernel
    alone at GPT-base's serve geometry (12 heads of 64, 16-token blocks,
    contexts of 1,024 to 2,048 positions, bf16 pool), greedy over the
    decode batch (8, 16, 32 slots), each trial timed from a replayed CUDA
    graph of 50 calls; the winner persisted to ``ledger`` and read
    back."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_autotune_torch_script", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts",
            "autotune_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    at = script._autotune
    payload = {"seq_len": 2048, "steps": 50, "warmup": 1,
               "kv_block_size": None, "spec_k": None}
    t0 = time.perf_counter()
    trials = {}

    def measure(trial):
        rec = script.measure_serve_decode(trial, payload)
        trials[trial.config_key()] = {"graph_ms": rec["graph_ms"],
                                      "tokens_per_s": rec["value"]}
        return at.TrialResult(trial, value=rec["value"], unit=rec["unit"],
                              bound=rec["bound"], wall_s=rec["wall_s"])

    outcome = at.greedy_search(measure, at.TrialSpec(batch=16),
                               {"batch": [8, 16, 32]}, max_trials=3)
    metric = script.SERVE_DECODE_METRIC
    record = at.persist_winner(ledger, metric, outcome, backend="cuda",
                               source="chip_smoke.py",
                               extra={"workload": "serve_decode"})
    if at.read_winner(ledger, metric) != record:
        raise AssertionError("the persisted winner does not read back")
    return {"trials": trials, "winner": record["config_key"],
            "trial_count": outcome.trials,
            "seconds": time.perf_counter() - t0}


def compile_audit(ops) -> dict:
    """The compile cache across processes and in one, the bit-for-bit
    training with and without it, the program audit of the training and
    serving builds, and the serve_decode sweep."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out = {"phase": "compile_audit"}
    out["cache"] = cache_across_processes()
    out["cache_s"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="stoke-compile-audit-")
    try:
        t = time.perf_counter()
        runs = cached_training(ops, os.path.join(root, "cache"))
        out["training"] = {
            name: {k: v for k, v in r.items() if k != "stoke"}
            for name, r in runs.items()}
        out["training"]["cached_stats"] = \
            runs["cached"]["stoke"].compile_cache.stats()
        out["training_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["audit"] = audit_checks(ops, runs)
        out["audit_phase_s"] = time.perf_counter() - t
        for r in runs.values():
            r["stoke"].close_telemetry()
        del runs
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["sweep"] = decode_sweep(os.path.join(root, "autotune.json"))
        out["sweep_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        from stoke_tpu_torch import ops
        from stoke_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a stoke_tpu checkout ({e})",
              file=sys.stderr)
        return 1

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    seconds = _build.build()
    # per kernel: its (mangled) name, then its registers and spills
    ptxas = {n: [ln.strip()[:160] for ln in
                 (_build.build_log(n) or "").splitlines()
                 if "Function properties" in ln or "registers" in ln
                 or "spill" in ln]
             for n in _build.SOURCES}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flash = check_flash(ops, gen, flush)
    decode = check_decode(ops, gen, flush)
    flash_bwd = check_flash_bwd(ops, gen, flush)
    verify = check_verify(ops, gen, flush)
    quant = check_quant(ops, gen, flush)
    emit({"phase": "kernels", "card": smi, "flash_fwd": flash,
          "quant": quant, "quant_ptxas": ptxas_usage(
              _build.build_log("quant") or "", QUANT_KERNELS),
          "paged_decode": decode,
          "paged_decode_ptxas": ptxas_usage(
              _build.build_log("paged_decode") or "", DECODE_KERNELS),
          "flash_bwd": flash_bwd,
          "flash_fwd_fp32_ptxas": ptxas_usage(
              _build.build_log("flash_fwd") or "", FWD_TF32X3_KERNELS),
          "flash_bwd_fp32_ptxas": ptxas_usage(
              _build.build_log("flash_bwd") or "", TF32X3_KERNELS),
          "flash_wgmma_ptxas": {
              **ptxas_usage(_build.build_log("flash_fwd") or "",
                            WGMMA_KERNELS),
              **ptxas_usage(_build.build_log("flash_bwd") or "",
                            WGMMA_KERNELS)},
          "paged_verify": verify,
          "paged_verify_ptxas": ptxas_usage(
              _build.build_log("paged_verify") or "", VERIFY_KERNELS)})
    del flush
    torch.cuda.empty_cache()

    served = serve(ops)
    emit(served)
    torch.cuda.empty_cache()
    spec = serve_spec(ops)
    emit(spec)
    torch.cuda.empty_cache()
    squant = serve_quant(ops)
    emit({**squant, "card": smi})
    torch.cuda.empty_cache()
    trained = train(ops)
    emit({**trained, "card": smi})
    torch.cuda.empty_cache()
    emit(train_parity(ops))
    torch.cuda.empty_cache()
    emit(train_window(ops))
    torch.cuda.empty_cache()
    tel = train_telemetry(ops)
    emit({**tel, "card": smi})
    torch.cuda.empty_cache()
    fp16 = train_fp16(ops)
    emit(fp16)
    torch.cuda.empty_cache()
    emit({**checkpoint(ops), "card": smi})
    torch.cuda.empty_cache()
    emit({**train_resnet50(ops), "card": smi})
    torch.cuda.empty_cache()
    emit({**train_vit(ops), "card": smi})
    torch.cuda.empty_cache()
    bert = train_bert(ops)
    emit({**bert, "card": smi})
    torch.cuda.empty_cache()
    dp = train_dp(ops)
    emit({**dp, "card": smi})
    torch.cuda.empty_cache()
    comm = train_comm(ops)
    emit({**comm, "card": smi})
    torch.cuda.empty_cache()
    emit({**checkpoint_dp(ops), "card": smi})
    torch.cuda.empty_cache()
    res = train_resilience(ops)
    emit({**res, "card": smi})
    torch.cuda.empty_cache()
    off = offload(ops)
    emit({**off, "card": smi})
    torch.cuda.empty_cache()
    remat = train_remat(ops)
    emit({**remat, "card": smi})
    torch.cuda.empty_cache()
    obsv = observatories(ops)
    emit({**obsv, "card": smi})
    torch.cuda.empty_cache()
    fleet = fleet_ops(ops)
    emit({**fleet, "card": smi})
    torch.cuda.empty_cache()
    seqpar = train_seqpar(ops)
    emit({**seqpar, "card": smi})
    torch.cuda.empty_cache()
    tpep = train_tp_ep(ops)
    emit({**tpep, "card": smi})
    torch.cuda.empty_cache()
    pipe = train_pipeline(ops, t_main)
    emit({**pipe, "card": smi})
    torch.cuda.empty_cache()
    second = train_second_axis(ops)
    emit({**second, "card": smi})
    torch.cuda.empty_cache()
    third = train_three_axes(ops)
    emit({**third, "card": smi})
    torch.cuda.empty_cache()
    audit = compile_audit(ops)
    emit({**audit, "card": smi})

    def row(name, source, functions, replaces, launches, err, c, key="",
            fp32=None, bert_key=None, dp_key=None, tel_key=None):
        out = {
            "name": name, "route": "cuda",
            "source": f"stoke_tpu_torch/csrc/{source}.cu",
            "functions": functions,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": c[f"{key}ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c[f"{key}bound_ms"], "bound_by": c[f"{key}bound_by"],
            "library_ms": c["library_ms"],
        }
        if fp32 is not None:  # the fp32 kernel at the same shape
            out.update(fp32_ms=fp32[f"{key}ms"],
                       fp32_bound_ms=fp32[f"{key}bound_ms"],
                       fp32_library_ms=fp32["library_ms"])
        if dp_key is not None:  # train_dp's full-width runs (bf16)
            out["launches_train_dp"] = dp["launches"][dp_key]
        if tel_key is not None:  # train_telemetry's configured run (bf16)
            out["launches_train_telemetry"] = tel["launches"][tel_key]
            # the resilience phase's in-process lives and the offload runs
            out["launches_train_resilience"] = res["launches"][tel_key]
            out["launches_offload"] = off["launches"][tel_key]
            # remat's runs (the forward twice a step) and the observatories'
            out["launches_train_remat"] = remat["launches"][tel_key]
            out["launches_observatories"] = obsv["launches"][tel_key]
            # the fleet and ops plane's runs, and sequence parallelism's
            # training runs and virtual rings
            out["launches_fleet_ops"] = fleet["launches"][tel_key]
            out["launches_train_seqpar"] = seqpar["launches_total"][tel_key]
            # tensor and expert parallelism's runs and virtual splits
            out["launches_train_tp_ep"] = tpep["launches_total"][tel_key]
            # pipeline parallelism's runs (dense attention in the stages)
            out["launches_train_pipeline"] = pipe["launches_total"][tel_key]
            # the tiers, transports and sharded format under a second axis
            out["launches_train_second_axis"] = (
                second["launches_total"][tel_key])
            # the main path under three axes (GPT-base-MoE), and the
            # phase's other runs and virtual block beside it
            out["launches_train_three_axes"] = (
                third["launches_main"][tel_key])
            out["launches_train_three_axes_total"] = (
                third["launches_total"][tel_key])
        if bert_key is not None:  # train_bert's path and shapes (bf16)
            part, k = bert_key
            grads = {"": None, "dq_": ("dq",), "dkv_": ("dk", "dv")}[k]
            out["launches_train_bert"] = bert["launches"][name]
            out["bert"] = [
                {"L": c["L"], "ms": c[part][f"{k}ms"],
                 "bound_ms": c[part][f"{k}bound_ms"],
                 "bound_by": c[part][f"{k}bound_by"],
                 "library_ms": c[part]["library_ms"],
                 "max_abs_err": (c[part]["max_abs_err"] if grads is None
                                 else max(c[part]["max_abs_err"][n]
                                          for n in grads))}
                for c in bert["kernel_cases"]]
        return out

    # the training path's shape: L=1024, D=64, bf16 (and fp32)
    flash_main, flash_fp32 = (
        next(c for c in flash if c["B"] == TRAIN_BATCH
             and c["L"] == TRAIN_LEN and c["D"] == HEAD_DIM
             and c["dtype"] == dtype and c["causal"] and not c["masked"])
        for dtype in ("bfloat16", "float32"))
    bwd_main, bwd_fp32 = (
        next(c for c in flash_bwd if c["L"] == TRAIN_LEN
             and c["D"] == HEAD_DIM and c["dtype"] == dtype
             and c["causal"] and not c["masked"])
        for dtype in ("bfloat16", "float32"))
    # the fp16 instantiations at the training shape, launched on the fp16
    # path (train_fp16's eager steps)
    fwd16 = [c for c in flash if c["dtype"] == "float16"]
    bwd16 = [c for c in flash_bwd if c["dtype"] == "float16"]
    fwd16_main = next(c for c in fwd16 if c["L"] == TRAIN_LEN
                      and c["D"] == HEAD_DIM and c["causal"]
                      and not c["masked"])
    bwd16_main = next(c for c in bwd16 if c["L"] == TRAIN_LEN
                      and c["D"] == HEAD_DIM and c["causal"]
                      and not c["masked"] and c["do_scale"] == 1.0)
    emit({"kernels": [
        row("flash_fwd", "flash_fwd",
            ["flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel"],
            "stoke_tpu/ops/flash_attention.py:70",
            trained["launches"]["flash_fwd"],
            max(x["max_abs_err"] for x in flash if x not in fwd16),
            flash_main,
            fp32=flash_fp32, bert_key=("fwd", ""), dp_key="flash_fwd",
            tel_key="flash_fwd"),
        row("flash_bwd_dq", "flash_bwd",
            ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_tf32x3_kernel"],
            "stoke_tpu/ops/flash_attention.py:210",
            trained["launches"]["flash_bwd_dq"],
            max(x["max_abs_err"]["dq"] for x in flash_bwd if x not in bwd16),
            bwd_main, "dq_", bwd_fp32, bert_key=("bwd", "dq_"),
            dp_key="flash_bwd_dq", tel_key="flash_bwd_dq"),
        row("flash_bwd_dkv", "flash_bwd",
            ["flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_tf32x3_kernel"],
            "stoke_tpu/ops/flash_attention.py:246",
            trained["launches"]["flash_bwd_dkv"],
            max(max(x["max_abs_err"]["dk"], x["max_abs_err"]["dv"])
                for x in flash_bwd if x not in bwd16), bwd_main, "dkv_",
            bwd_fp32, bert_key=("bwd", "dkv_"), dp_key="flash_bwd_dkv",
            tel_key="flash_bwd_dkv"),
        row("flash_fwd_fp16", "flash_fwd", ["flash_fwd_wgmma_kernel<__half>"],
            "stoke_tpu/ops/flash_attention.py:70",
            fp16["launches"]["flash_fwd"],
            max(x["max_abs_err"] for x in fwd16), fwd16_main),
        row("flash_bwd_dq_fp16", "flash_bwd",
            ["flash_bwd_dq_wgmma_kernel<__half>"],
            "stoke_tpu/ops/flash_attention.py:210",
            fp16["launches"]["flash_bwd_dq"],
            max(x["max_abs_err"]["dq"] for x in bwd16), bwd16_main, "dq_"),
        row("flash_bwd_dkv_fp16", "flash_bwd",
            ["flash_bwd_dkv_wgmma_kernel<__half>"],
            "stoke_tpu/ops/flash_attention.py:246",
            fp16["launches"]["flash_bwd_dkv"],
            max(max(x["max_abs_err"]["dk"], x["max_abs_err"]["dv"])
                for x in bwd16), bwd16_main, "dkv_"),
        {**row("paged_decode", "paged_decode", list(DECODE_KERNELS),
               "stoke_tpu/ops/flash_attention.py:581",
               served["launches"]["paged_decode"],
               max(x["max_abs_err"] for x in decode), decode[0]),
         "graph_ms": decode[0]["graph_ms"],
         "launches_serve_traced":
             tel["serve_traced"]["launches"]["paged_decode"],
         "launches_observatories": obsv["launches"]["paged_decode"],
         "launches_fleet_ops": fleet["launches"]["paged_decode"]},
        # launches: the greedy and the sampled speculative runs
        {**row("paged_verify", "paged_verify", list(VERIFY_KERNELS),
               "stoke_tpu/ops/flash_attention.py:836",
               spec["greedy"]["launches"]["paged_verify"]
               + spec["sampled"]["launches"]["paged_verify"],
               max(x["max_abs_err"] for x in verify), verify[0]),
         "graph_ms": verify[0]["graph_ms"],
         "launches_observatories": obsv["launches"]["paged_verify"]},
        *quant_rows(quant, comm, squant, res["elastic"]["launches"],
                    second["launches_total"], third["launches_main"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resilience-worker"]:
        sys.exit(resilience_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--cache-worker"]:
        sys.exit(cache_worker(sys.argv[2:]))
    sys.exit(main())
