#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, quantized-inference,
MoE-serving, MoE-training, block-sparse and evoformer attention paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and passed):

0. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
1. build every CUDA kernel of the path from ``deepspeed_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together; the sources include
   ``csrc/hopper.cuh`` and ``csrc/wide_head.cuh``), and beside them the
   parent commit's build of seven sources, from ``baselines/previous/``
   with the parent's ``hopper.cuh``, run under today's wrappers: every
   kernel must give the parent's bits (the timed cases run in turns with
   the parent's); ptxas's registers and spills per kernel, and the
   kernels that spill by name;
2. kernel A, flash-attention forward, against its plain PyTorch version
   computed in fp32 on the same inputs (limits in ``FLASH_TOL``/``LSE_TOL``) on
   the card at llama-1b prefill shapes (+ a chunked-prefill window,
   ALiBi, fp32 and fp16 cases (fp16 causal at the training shape and at
   D = 224, timed), D = 72, 80, 96, 160 and 256, strided q/k/v
   views bit-equal to contiguous copies; D = 288, 320 and 512 in bf16 and
   fp32, causal and a chunk window with ALiBi, through the runtime-head-dim
   kernel), timed beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` as a yardstick at the serving shape,
   the training shape (B=4), llama-7b's heads (D=128) and D = 512; the
   parent's build timed in turns with this one (parent, new, new, parent)
   and bit-equal to it;
3. kernel B, paged decode attention, the same way at the decode shapes of
   llama-1b (bf16 and int8 pages), llama-7b (bf16 and int8 pages) and
   Mixtral-8x7b (+ a NaN-poisoned trash page, ALiBi, D = 72, 80, 96 and
   160, falcon-7b's 71 query heads over one KV head, 16 query heads of
   256 over 2, fp32 pools at D = 200 and 256, pages of 128 and 256
   slots, and D = 288, 320 and 512 with bf16 and int8 pages; ``PAGED_TOL``;
   every output bit-equal across two calls and to the parent's build,
   timed in turns with it);
4. the engine: ``InferenceEngineV2`` serving llama-1b at full width and
   depth in bf16 with random seeded weights, 12 greedy requests (each a
   repeated random pattern) through 8 slots, five times: whole-prompt and
   256-token chunked prefill, ``decode_horizon = 8``, n-gram speculation
   (k = 4) and a tiny draft model; the decode, multi-step and verify
   programs are CUDA graphs captured when the engine is built.  The
   launch counters (which a replay advances) are zeroed just before each
   drive and read just after: every prefill layer (and draft forward)
   must have gone through kernel A and every decode body through kernel
   B; the profiler must name one ``paged_decode_kernel`` per layer in a
   decode replay, and L x bodies across the 8-step program's replays; a
   captured step must give eager ``paged_decode``'s tokens on cloned
   pools, and horizon 8 the single step's streams.  Wall and device time
   per step and the idle share, tokens per host sync and per invocation,
   the acceptance rate and peak memory with the graphs;
5. parity: a 2-layer llama-1b-width model in fp32, the card's engine
   against the port's CPU engine on the same weights: identical greedy
   streams and prefill logits within 2e-3, and identical streams and
   counters with int8 KV, under preemption, at horizon 4, with n-gram
   speculation and for sampled rows (plain and horizon 4); then llama-1b
   at full width and depth in fp32: the single-step, 8-step and n-gram
   programs serve identical greedy streams and a captured step gives
   eager ``paged_decode``'s tokens (``decode_parity_phase``);
6. kernels A' (dQ) and A'' (dK, dV), flash-attention backward, against
   their plain version computed in fp32 from the same inputs, lse and delta
   (``FLASH_BWD_TOL``) at the llama-1b training shape (B=4 S=1024 NH=32
   KVH=8 D=64 bf16 causal) and llama-7b's heads (B=2 S=2048 NH=KVH=32
   D=128), both timed beside their bounds, the plain version and SDPA's
   backward, and GQA, ALiBi, uneven-S, D = 72, 80, 96 and 160, fp16 and
   fp32 corners (fp16 causal at the training shape, timed, and at D = 80,
   S = 130), D = 288, 320 and 512 (bf16 causal, fp32 full; timed at
   512); bf16/fp16 gradients bit-equal across two calls, strided q/k/v/dO
   views bit-equal to their contiguous copies, and at the timed shapes
   bit-equal to the parent's build, timed in turns with it;
7. kernel C, fused Adam, against its plain version (``ADAM_TOL``) on the
   65.5M-element embedding leaf of llama-1b (timed beside its bound and
   ``torch._fused_adamw_``) and odd-sized, unaligned and bf16-moment leaves;
8. training: ``deepspeed_tpu_torch.initialize`` -> ``train_batch`` on
   llama-1b at full width and depth (bf16, seq 1024, micro-batch 4, AdamW
   with the fused kernel, clipping 1.0), 8 steps at gas 1 on one seeded
   batch (the loss must fall) and 2 at gas 2.  Counters zeroed before and
   read after each drive: every attention layer of every micro-step
   launched kernels A, A' and A'' and every leaf of every optimizer step
   kernel C, and PyTorch's sync debug mode saw no host sync inside any
   train_batch call.  Step time, tokens/s, MFU, a profiled step's device
   idle share and top kernels, peak memory;
9. training parity: a 2-layer llama-1b-width model on the card and on the
   CPU from the same weights and batches, fp32 for 3 steps and fp16 through
   an overflow step (``TRAIN_PARITY_TOL``; loss scale and skipped steps
   equal);
10. kernel W, the weight-only quantized matmul, against its plain version
    computed in fp32 on the same inputs (``WQ_TOL``) at llama-7b's four
    matrix shapes, decode (M = 8) and prefill (M = 900), int8 and int4, bf16
    x (timed beside its bound, its plain version, the parent's build in
    turns and bit-equal to it, and, as context only, a cuBLAS bf16 GEMM on
    the dequantized weight; for int4 at group 128,
    ``torch._weight_int4pack_mm`` on the repacked codes), M = 1, 16, 17 and
    64, fp16 and fp32 x, padded K,
    unaligned K and N, and groups 64, 16 and 48; every output bit-equal
    across two calls;
11. kernels Q and DQ, int8 block quantize / dequantize, bit-equal to their
    plain versions (lengths off 128, more rows than ``block_rows``, an
    all-zero row; fp32, bf16, fp16), timed on llama-1b's 65.5M-element
    ``embed.tok``;
12. quantized serving: ``InferenceEngineV2(quant_bits=8)`` and ``=4``
    serving llama-7b at full width and depth (bf16, seeded random weights),
    12 greedy requests through 8 slots, whole-prompt prefill.  Counters
    zeroed before and read after each drive: exactly 7 x 32 + 1 = 225 W
    launches per prefill and per decode call, flash and paged on every
    layer, and the profiler naming 225 W and 32 B kernels in one replay of
    the captured decode step; the last-token prefill logits of one prompt by cosine
    (``WQ_COSINE``, ``WQ_DEQUANT_COSINE``): at 2 layers of llama-7b's width
    against the bf16 engine (int8 > 0.999, the JAX package's limit) and
    against the bf16 model on the dequantized weights (both > 0.999), and
    reported at full depth beside the bf16 engine's own cosine against
    fp32; param bytes, peak memory, TTFT, tokens/s, a profiled decode
    step with W's share of its device time;
13. dense-cache inference: ``deepspeed_tpu_torch.init_inference`` ->
    ``generate`` on llama-1b at full width and depth (bf16, B = 4, 128-token
    prompts, 32 greedy tokens), ``module_quantize`` (one Q and one DQ launch
    per stacked leaf of two or more dimensions: 11) and ``generate`` again;
    ``lora_linear`` over an int8 base launches DQ;
14. quantized parity: a 2-layer llama-1b-width model in fp32 on the card and
    on the CPU from the same weights: identical greedy streams from
    ``InferenceEngineV2`` with ``quant_bits`` 8 and 4, and from
    ``InferenceEngine.generate`` before and after ``module_quantize``;
15. kernel G, the grouped expert matmul, against its plain version computed
    in fp32 on the same inputs (``GMM_TOL``) at Mixtral-8x7b's shapes in the
    router's padded layouts, decode (8 tokens: P = 1152) and prefill (1024
    tokens: P = 3072), gate/up (4096 x 14336) and down (14336 x 4096), bf16
    (timed beside its bound, its plain version, ``torch._grouped_mm`` and,
    as context, a dense cuBLAS GEMM of the same rows; the bound counts the
    routed rows, 2 x tokens, not the padded P), fp16 and fp32; a
    non-monotone block -> expert map at block_rows 8 and 16, ragged F and
    H, one expert for every block; the count of used blocks (``n_used``)
    skipping the padding, bit-equal across calls; the timed cases bit-equal
    to the parent's build and timed in turns;
16. MoE serving: Mixtral-8x7b at full width and 16 of 32 layers (bf16,
    dropless, seeded random weights) through ``InferenceEngineV2``, the 12
    requests of phase 4 with whole-prompt and 256-token chunked prefill,
    exactly 3 x 16 G launches per prefill, chunk and decode call, flash and
    paged on every layer, the profiler naming 48 G and 16 B kernels in one
    replay of the captured decode step; TTFT, tokens/s, profiled decode and prefill steps,
    peak memory; then ``init_inference`` -> ``generate`` on the same tree (B
    = 4, 128-token prompts, 16 greedy tokens, 48 G launches per call);
17. MoE parity: a 1-layer Mixtral-8x7b-width model in fp32 on the card and
    on the CPU from the same weights, dropless and capacity: prefill logits
    within ``PARITY_LOGITS_TOL``, identical router top-2 choices, identical
    greedy streams from ``InferenceEngineV2`` and ``init_inference``;
18. kernel S, block-sparse attention, against its plain version computed in
    fp32 on the same inputs (``SPARSE_TOL``) at BERT-large's heads at S =
    4096 (B = 1, H = 16, D = 64, bf16, block 128) for the Fixed,
    BSLongformer and BigBird layouts, causal and not (timed beside the
    bound of their visible block pairs, the plain version and SDPA on the
    layout expanded to a boolean mask), and corners (Dense, fp16 and fp32,
    heads from a 1-head layout, block 256, an all-empty layout row whose
    output is 0, D = 72, 80 and 160, blocks 8, 16, 24, 32, 48 and 64 with S
    off a multiple of 128, q/k/v read by cp.async (rows 8-byte aligned, and
    K/V expanded over the heads), D = 288, 320 and 512, timed at 512), every
    output bit-equal across two calls; the parent's kernel on the same
    inputs held to the same limit in bf16/fp16 (its bits in fp32 and past
    256), the timed cases timed in turns with it;
    the path: the six main calls of the entry point, counter zeroed before
    and read after (one launch each), the profiler naming the wgmma kernel
    in each; a CUDA call with inputs that require a gradient raises;
19. kernels E, E', E'' (evoformer forward, dQ + dbias1, dK/dV + dbias2)
    against their plain versions computed in fp32 (``EVO_TOL``,
    ``EVO_BWD_TOL``, ``EVO_DBIAS_TOL``) at AlphaFold 2's MSA row attention
    with pair bias (B = 1, S = 512, N = 384, H = 8, D = 32, bf16) and its
    triangle attention (S = N = 384, H = 4), timed beside their bounds, the
    plain versions, each against the parent's in turns, and SDPA with
    the biases summed into a float mask (and its backward, without and with
    the mask's gradient reduced to dbias1 and dbias2: E' + E''s
    same-function yardstick); E and E'' bit-equal to the parent's build, the
    parent's E' held to the same limits; corners: no
    bias, bias1 only, [None, b2], D = 16/64/128, ragged N = 300 and Q != K,
    fp16, fp32, a row masked by -1e9, K = 700 past the pair bias E keeps
    resident, an odd count of MSA rows, and the
    query ranges of E'' past one block's dbias2 accumulator (N = 640 bf16,
    N = 300 fp32 D = 128), and the key ranges of E' past one block's
    dbias1 accumulator (K = 6,000 bf16 and 16,000 fp32 at D = 128), and
    E''s K/V tiles at the last K that keeps them resident per head and the
    first that streams them (bf16, D = 32 and 128); every backward bit-equal
    across two calls;
20. the evoformer training path: ``DS4Sci_EvoformerAttention(q, k, v,
    [b1, b2])`` -> ``backward`` at the main shape, one E, E' and E''
    launch and no plain call (the profiler naming E''s wgmma kernel), the
    five gradients within ``EVO_BWD_TOL`` of plain fp32 autograd through
    ``evoformer_attention_xla``, bit-equal across two calls, and a peak
    memory below the 2.42 GB of the scores;
21. kernels G' and G'' (the grouped matmul's backward: grouped dX and
    per-expert dW) against their plain versions computed in fp32
    (``GMM_TOL``) at Mixtral-8x7b's and Mixtral-8x160m's training layouts
    (4096 tokens at top-2 through the router, P = 9216; gate/up and down;
    bf16 timed beside their bound, their plain versions and
    ``torch._grouped_mm``, the 3-D form for dX and the 2-D x 2-D form
    grouped along K for dW, and in rounds of turns with the parent's
    build) and at a small batch (512 tokens, P = 2048, where the parent
    split G''s K and G' splits none), fp16 and fp32, block_rows 64 and 16,
    an expert with no rows in a non-monotone map, ``n_used`` below the
    block count and 0, ragged H and F, an odd count of 128-row tiles of H
    and of 128-column tiles of F, an odd run of tiles at the last expert,
    experts alternating (more runs than G''s slots) at K 1024, 192 and
    128; every output bit-equal across two calls and to the parent's build
    (G' where the parent split no K), and the router's ``n_used`` giving
    the bits of the whole buffer;
22. MoE training: ``initialize`` -> ``train_batch`` on Mixtral 8x160m at
    full width and depth (bf16, dropless, seq 1024, micro-batch 4, the
    bench's ds-config without telemetry), 8 steps on one seeded batch (the
    loss must fall, no host sync inside a step, a profiled step), and
    Mixtral 8x7b at full width and 2 of 32 layers with remat
    (nothing_saveable) and without, 2 steps each: counters zeroed before
    and read after each drive (per step: A L times, 2L with remat, A'
    and A'' L times, G 3L, 6L with remat, G' and G'' 3L, C once per
    leaf), the first micro-batch's loss and every gradient, the losses
    and the grad norms bit-equal with and without remat; step time,
    tokens/s, MFU (active experts only), peak memory;
23. MoE training parity: a 2-layer Mixtral-8x160m-width model (dropless)
    in fp32 on the card and on the CPU from the same weights and batches,
    3 steps (``TRAIN_PARITY_TOL``);
24. ZeRO-Offload: ``initialize`` -> ``train_batch`` on llama-7b at full
    width and depth (bf16, AdamW, clipping 1.0, stage 2, seq 1024,
    micro-batch 2, bf16 gradient accumulation) with the fp32 master and
    both Adam moments in host RAM, updated there by the C++ Adam
    (``offload_optimizer.device`` "cpu"; "nvme" when MemAvailable holds
    the master but not the moments; the depth cut, printed as
    ``reduced``, only when neither fits), 4 steps on one seeded batch: the
    loss falls, no fp32 master or moment on the card, A, A' and A'' (D =
    128) every layer every step; the step's parts (forward and backward,
    the device-to-host and host-to-device copies, the host update and its
    GB/s against the host's memory rate, phase 25's), tokens/s, MFU, peak
    device memory, the host RAM held;
25. the host ops alone on a llama-7b MLP leaf: cpu_adam, cpu_lion,
    cpu_adagrad and ``torch._fused_adamw_`` on CPU tensors beside their
    bound (bytes over the fastest of a STREAM-style triad on every core
    and these ops); the async-I/O engine's write and read rates;
26. llama-1b offload, 2 steps each: NVMe bit-equal to cpu offload,
    SuperOffload with 4 and 1 workers bit-equal to plain offload;
27. ZenFlow: llama-160m's loss falls with 10 % of the columns per step;
    ``topk_ratio`` 1.0 within 1e-5 of the AdamW offload engine;
28. ``offload_param`` on llama-1b: losses and masters bit-equal to the
    device path, kernel C once per leaf per step, peak memory of each;
29. the hybrid engine: 2 offload steps on llama-1b, then a greedy
    ``generate`` of 16 tokens from the live leaves (no second copy),
    equal to ``init_inference`` on ``get_params()`` in bf16;
    ``offload_states`` frees the card's weights and ``reload_states``
    brings back the same tokens;
30. lamb, lion, adagrad, sgd, muon and the 1-bit family, card against
    CPU: each update's arithmetic on identical leaves and gradients
    (``OPTIMIZER_TOL``), and the five without a quantiser through a
    2-layer llama-160m-width model, 3 fp32 steps (``TRAIN_PARITY_TOL``,
    the params held by the norm of their difference against the norm of
    their movement);
31. ``cpu_checkpointing`` and the ``offload_dots`` policy on llama-1b:
    losses and masters bit-equal to remat without them; the device memory
    a forward's graph holds until its backward, and the peaks of the
    forward + backward and of the step, beside remat's and no remat's;
32. falcon-7b at full width and depth (H 4544, 71 query heads over one KV
    head, D 64, 32 layers, bf16, seeded weights drawn on the card) written
    by the port's ``save_hf_checkpoint`` as a sharded safetensors
    directory under ``build/hf/`` (the depth cut, and the cut printed, only
    where the free disk holds less than twice the checkpoint), served by
    ``InferenceEngineV2.from_pretrained`` with whole-prompt and 256-token
    chunked prefill, ``decode_horizon = 8``, 8 greedy requests of 16 to 900
    tokens through 8 slots (one A launch per layer per prefill call, one B
    per layer per decode body), TTFT, the decode body's time, a profiled
    decode step and peak memory; then ``init_inference(<dir>)`` ->
    ``generate``; each load's host resident set above what it was before,
    within ``HF_LOAD_RSS_LIMIT`` of the checkpoint's bytes;
33. phi-2 (D 80), gpt-neox-20b (D 96), bloom-7b1 (ALiBi through A and B),
    qwen2-7b, mistral-7b and opt-6.7b at full width and 2 layers, each
    written as an HF directory and served by ``from_pretrained`` the same
    way (4 greedy requests of 16 to 400 tokens);
34. each of the seven families at full width and 1 layer in fp32, the
    card's engine against the CPU's on the same weights: identical greedy
    streams, prefill logits within ``PARITY_LOGITS_TOL``;
35. GPT-2 1.3B (24 layers, H 2048, learned positions) trained at full
    width and depth: bf16, ZeRO stage 2, fused AdamW, clipping 1.0, seq
    1024, micro-batch 4, 8 steps on one batch (the loss falls; A, A' and
    A'' on every layer and C on every leaf of every step; no host sync);
    step time, MFU, a profiled step's idle share, peak memory;
36. BERT-base MLM (post-norm, 12 layers, H 768) trained the same way at
    ZeRO 1, seq 512, micro-batch 16: the non-causal A, A' and A'' on every
    layer of every step; then one step with an ``attention_mask``, which
    takes the plain attention (no A launch), as both packages do.
37. checkpoints and training from a dataset (``checkpoint_phase``): (a)
    llama-1b at full width and depth, the train phase's config, fed from a
    Megatron indexed dataset of seeded uint16 tokens (64 sequences of
    1025) through ``initialize(training_data=...)`` -> ``train_batch()``:
    3 steps, save, 3 more; a fresh engine loads the tag and takes the same
    3 steps on the same batches: losses and fp32 master bit-equal (A, A',
    A'' every layer, C every leaf, every step); save and load seconds and
    GB/s, the seconds ``resolve_tag`` takes to verify, the host
    resident-set and device-peak rises of each; (b) llama-7b at full width
    under ``offload_optimizer`` cpu, cut to 4 of 32 layers (the cut
    printed), 2 steps each side of the save, bit-equal, the device peak of
    the save and the load within 1 GiB, the host resident set within 0.25x
    the checkpoint (save) and 2x its largest stacked member (load); (c)
    (a)'s tag through ``checkpoint_to_hf`` into an HF directory served by
    ``init_inference(<dir>)``: greedy streams equal to the live params'.
    Phases 2 and 6 hold A and A'/A'' at falcon-7b's 71:1 and BERT-base's
    non-causal shape too; dK and dV of a group wider than 4 (A'' with P
    and dS as two bf16 terms) within the unscaled ``FLASH_BWD_TOL`` of
    the fp32 plain version, SDPA's own error beside them, timed in turns
    with the parent's one-term build.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Needs one CUDA card,
``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and the repository beside
this file; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,  # dense tensor core
            torch.float32: 67e12}                            # fp32 outside the tensor cores
#: A kernel is held against its plain version computed in fp32 from the
#: same inputs: |out - ref| <= atol + rtol * |ref| everywhere.  rtol is the
#: rounding of the output to its dtype (half an ulp: 2^-8 bf16, 2^-11 fp16,
#: 2^-24 fp32).  atol covers the rounding inside the kernel and is about
#: twice the maximum observed on an H100 (PERF.md): flash rounds the
#: probabilities to the input dtype as the PV operand (3.5e-3 bf16, 9.1e-5
#: fp16, 4.4e-7 fp32); paged decode keeps them fp32 and needs none beyond
#: the output's rounding (0 bf16, 1.6e-7 fp16, 3.5e-7 fp32), so it gets a
#: small floor.  LSE is fp32 (observed 9.5e-7, two ulps near 7): 1e-5;
#: dropping one 64-key tile of 1024 keys moves it by ~6e-2.
FLASH_TOL = {torch.bfloat16: (7e-3, 2.0 ** -8), torch.float16: (2e-4, 2.0 ** -11),
             torch.float32: (1e-6, 2.0 ** -24)}
PAGED_TOL = {torch.bfloat16: (1e-5, 2.0 ** -8), torch.float16: (1e-5, 2.0 ** -11),
             torch.float32: (1e-6, 2.0 ** -24)}
LSE_TOL = 1e-5
#: The backward kernels keep every sum in fp32.  In bf16/fp16 they round P
#: and dS to the input type as tensor-core operands, which their plain
#: version, run in fp32 on the fp32 copies of the same inputs with the same
#: lse and delta, does not; in fp32 they differ from it by summation order
#: only.  rtol is the gradients' own rounding, as above; atol about twice the
#: largest need observed on an H100 (PERF.md): 1.05e-2 bf16 (dV, |dV| up to
#: 9), 3.2e-4 fp16, 5.5e-6 fp32 (dK/dV of GQA heads summed in another order).
FLASH_BWD_TOL = {torch.bfloat16: (2.2e-2, 2.0 ** -8), torch.float16: (7e-4, 2.0 ** -11),
                 torch.float32: (1e-5, 2.0 ** -24)}
#: dK and dV of a KV head sum over the G query heads of its group and every
#: query row.  Past a group of 4, bf16 A'' keeps P and dS as two bf16 terms
#: (``flash_attention.dkv_two_terms``): with one, falcon-7b's 71:1 needed
#: 0.026 / 0.032 against this 0.022.  Every group is held to FLASH_BWD_TOL.
#: Adam: both versions are fp32 in the same order of operations; the
#: compiler's fused multiply-adds round an intermediate an ulp apart (rtol
#: 2^-20, a few ulps).  A bf16 first moment may then round to the
#: neighbouring bf16 value (rtol 2^-7).  atol: twice the observed 1.5e-10.
ADAM_TOL = {torch.float32: (3e-10, 2.0 ** -20), torch.bfloat16: (3e-10, 2.0 ** -7)}
#: Kernel W sums each group's x . q in fp32 and scales it once; its plain
#: version multiplies x by the fp32 dequantized weight (the JAX kernel's
#: x @ (q * s)).  rtol is the output's rounding; atol about twice the
#: largest need observed on an H100 in this script's cases (PERF.md): bf16
#: 1.3e-5 (K = 11008), fp16 6.6e-6, fp32 1.8e-5 (outputs up to |11|, fp32
#: sums in other orders).
WQ_TOL = {torch.bfloat16: (2.6e-5, 2.0 ** -8), torch.float16: (1.3e-5, 2.0 ** -11),
          torch.float32: (3.6e-5, 2.0 ** -24)}
#: Cosine of the quantized engines' last-token prefill logits, on a 2-layer
#: model of llama-7b's width (the JAX package's check is on a 2-layer model,
#: tests/unit/test_inference_v2.py:255): against the bf16 engine, int8 is
#: held to the JAX limit 0.999.  JAX's int4 limit (0.98) is for its 64-wide
#: model; at 4096 wide the int4 codes themselves move a random model's
#: logits further, so int4 is reported there, not held.  Against the bf16
#: engine run on the dequantized weights both widths are held to
#: WQ_DEQUANT_COSINE: the kernel path computes what the codes say.  At full
#: depth random weights amplify every rounding from layer to layer; there
#: the cosines are reported beside the bf16 engine's own against fp32.
WQ_COSINE = {8: 0.999}
WQ_DEQUANT_COSINE = 0.999
PARITY_LOGITS_TOL = 2e-3
DEV = "cuda"
#: the parent commit's build of the kernels, built beside today's from
#: their sources in BASELINE_DIR (which holds the parent's hopper.cuh, found
#: before csrc's by their includes): every kernel must give the parent's
#: bits; the timed cases run in turns with the parent's.
BASELINE_DIR = os.path.join(ROOT, "baselines", "previous")
BASELINE_KERNELS = ("wq_matmul", "evoformer_attn", "flash_attention_fwd",
                    "flash_attention_bwd", "paged_attention", "sparse_attention",
                    "grouped_matmul")


def register_baselines(op_builder):
    """Add the previous kernels' sources to the builder under ``*_previous``
    names."""
    from pathlib import Path

    for name in BASELINE_KERNELS:
        op_builder.SOURCES[name + "_previous"] = Path(BASELINE_DIR) / f"{name}.cu"


class Baseline:
    """The parent's kernels, run through today's wrappers with the parent's
    library swapped in (``swapped``): every C entry point kept its
    signature."""

    def __init__(self, op_builder):
        from deepspeed_tpu_torch.ops import evoformer_attn as ev
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import grouped_matmul as gm
        from deepspeed_tpu_torch.ops import paged_attention as pa
        from deepspeed_tpu_torch.ops import sparse_attention as sa
        from deepspeed_tpu_torch.ops import wq_matmul as wq

        self.ob = op_builder
        sigs = {"flash_attention_fwd": fa._SIG, "flash_attention_bwd": fa._BWD_SIG,
                "paged_attention": pa._SIG, "sparse_attention": sa._SIG,
                "wq_matmul": wq._SIG, "evoformer_attn": ev._SIG, "grouped_matmul": gm._SIG}
        self.libs = {n: op_builder.load(n + "_previous", sigs[n]) for n in BASELINE_KERNELS}
        for n in BASELINE_KERNELS:  # today's, loaded before any swap
            op_builder.load(n, sigs[n])

    def swapped(self, name, fn):
        """``fn()`` with the previous library of ``name`` in place of today's
        (the same C signature), today's restored after."""
        cur = self.ob._libs[name]
        self.ob._libs[name] = self.libs[name]
        try:
            return fn()
        finally:
            self.ob._libs[name] = cur


#: set in main(): the parent's kernels
BASE = None


def turns(prev, new):
    """Device ms of ``prev`` and ``new`` timed in turns (prev, new, new,
    prev) in one process on one card: (prev mean, new mean, the four)."""
    t = [device_ms(prev), device_ms(new), device_ms(new), device_ms(prev)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def same_as_previous(rec, name, prev_out, out):
    """The parent's outputs ``prev_out`` beside today's ``out`` on the same
    inputs: bit-equal in every dtype."""
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(prev_out, out))
    check(same, f"{name}: other bits than the parent's build")
    rec["bit_equal_to_previous"] = same


class SmokeFailure(SystemExit):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(f"chip_smoke: FAILED: {what}")


#: profiled windows per measurement.  The profiler can record none or only
#: part of a window's kernels without an error; a window that recorded
#: fewer kernel launches than the fullest one is dropped, and the median of
#: the rest is kept.
PROFILER_WINDOWS = 3


def _profiled_us(fn, iters: int, activities) -> tuple:
    """(device µs summed over every kernel, wall µs, the kernels' key
    averages) of ``iters`` calls of ``fn`` under torch.profiler: the median
    over the fullest of ``PROFILER_WINDOWS`` windows; (0, wall, []) when no
    window recorded any device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    windows = []
    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in dev)
        windows.append((busy_us, sum(e.count for e in dev), wall_us, dev))
    fullest = max(w[1] for w in windows)
    if fullest == 0:
        return 0.0, windows[-1][2], []
    kept = sorted((w for w in windows if w[1] == fullest), key=lambda w: w[0])
    busy_us, _, wall_us, dev = kept[len(kept) // 2]
    return busy_us, wall_us, dev


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean device time of the kernels ``fn`` launches, per call: the
    self device time torch.profiler records, summed over every kernel and
    divided by ``iters``.  Host launch gaps between calls are left out (at
    these sizes the Python wrapper can take longer to launch a kernel than
    the kernel takes to run).  If the profiler records nothing in any of
    its windows, CUDA events around the same calls give the time instead
    (host gaps included), and a ``timing_fallback`` line says so."""
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    us, _, _ = _profiled_us(fn, iters, [ProfilerActivity.CUDA])
    if us > 0:
        return us / iters / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    print(json.dumps({"timing_fallback": "cuda_events", "ms": ms}))
    return ms


def demangle(name):
    """A kernel's C++ name from its symbol (``c++filt`` where there is one)."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=10).stdout.strip() or name
    except (OSError, subprocess.SubprocessError, TypeError):
        return name


def profiled_kernels(fn) -> dict:
    """{kernel name: launches} of the device kernels one call of ``fn``
    launched, as torch.profiler recorded them: the fullest of
    ``PROFILER_WINDOWS`` windows (a window can record none of its kernels
    without an error)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = {}
    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if sum(names.values()) > sum(best.values()):
            best = names
    return best


def max_err(out, ref, tol):
    """(max |out - ref|, the least atol that the elementwise limit
    ``atol + rtol * |ref|`` would need at ``tol``'s rtol, whether the limit
    holds everywhere)."""
    atol, rtol = tol
    d = (out.float() - ref.float()).abs()
    excess = (d - rtol * ref.float().abs()).clamp_min(0).max().item()
    return d.max().item(), excess, excess <= atol


def bound(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask, g, is_causal=False):
    """F.scaled_dot_product_attention on [B, H, S, D] views (yardstick)."""
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                              enable_gqa=g > 1)
    except TypeError:  # a PyTorch without enable_gqa
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), attn_mask=mask,
            is_causal=is_causal)


def warm_clocks(seconds: float = 1.0) -> None:
    """Keep the card busy for about ``seconds`` so the first timings do not
    run at idle clocks, and start the profiler's tracing once."""
    a = torch.randn((4096, 4096), device=DEV, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    device_ms(lambda: a @ a, iters=2, warmup=0)


# -- phase 2: flash-attention forward ---------------------------------------

def flash_case(fa, name, B, Sq, Sk, NH, KVH, D, dtype, causal=True, q_offset=0,
               alibi=False, valid_k=None, timed=False, seed=0, strided=False):
    """Kernel A against its plain version; ``strided``: q/k/v are views of
    one [B, S, 3, H, D] projection (Sq == Sk, NH == KVH), read in place and
    bit-equal to their contiguous copies."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    if strided:
        qkv = torch.randn((B, Sq, 3, NH, D), generator=g, device=DEV).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn((B, Sq, NH, D), generator=g, device=DEV).to(dtype)
        k = torch.randn((B, Sk, KVH, D), generator=g, device=DEV).to(dtype)
        v = torch.randn((B, Sk, KVH, D), generator=g, device=DEV).to(dtype)
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    kw = dict(causal=causal, q_offset=q_offset, alibi_slopes=slopes, valid_k=valid_k)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err, atol_used, ok = max_err(o, o_ref, FLASH_TOL[dtype])
    lse_err = (lse - lse_ref).abs().max().item()
    rec = {"case": name, "shape": [B, Sq, Sk, NH, KVH, D], "dtype": str(dtype)[6:],
           "causal": causal, "q_offset": q_offset, "alibi": alibi, "valid_k": valid_k,
           "max_abs_err": err, "atol_used": atol_used, "lse_max_abs_err": lse_err,
           "tol": FLASH_TOL[dtype], "lse_tol": LSE_TOL}
    print(json.dumps({"flash_check": rec}))
    check(bool(torch.isfinite(o).all()), f"flash {name}: non-finite output")
    check(ok, f"flash {name}: kernel vs fp32 plain beyond {FLASH_TOL[dtype]} "
          f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    check(lse_err <= LSE_TOL, f"flash {name}: lse beyond {LSE_TOL} (max abs {lse_err:.3g})")
    if strided:
        oc, lc = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        torch.cuda.synchronize()
        same = torch.equal(o, oc) and torch.equal(lse, lc)
        check(same, f"flash {name}: strided views give other bits than contiguous copies")
        rec["bit_equal_to_contiguous"] = same

    def new():
        return fa.flash_attention_fwd(q, k, v, **kw)

    def prev():
        return BASE.swapped("flash_attention_fwd", new)

    if BASE is not None:
        same_as_previous(rec, name, prev(), (o, lse))  # the parent's build, same inputs
    if timed:
        rows = q_offset + torch.arange(Sq, device=DEV)
        vis = (rows[:, None] >= torch.arange(Sk, device=DEV)[None, :]) if causal \
            else torch.ones((Sq, Sk), dtype=torch.bool, device=DEV)
        pairs = int(vis.sum().item()) * B * NH
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs, dtype)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        # plain causal (q_offset 0, square) takes SDPA's own causal path;
        # offsets and ALiBi need an explicit mask
        top_left = causal and q_offset == 0 and Sq == Sk and not alibi
        mask = None if top_left else vis
        if alibi:
            rel = (rows[:, None] - torch.arange(Sk, device=DEV)[None, :]).float()
            mask = torch.where(vis, -slopes[:, None, None] * rel, float("-inf")).to(dtype)
        rec.update(
            plain_ms=device_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw)),
            library_ms=device_ms(lambda: sdpa(qh, kh, vh, mask, NH // KVH, top_left)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=4.0 * D * pairs)
        if BASE is None:
            rec["ms"] = device_ms(new)
        else:  # the parent's build in turns
            prev_ms, rec["ms"], four = turns(prev, new)
            rec.update(previous_ms=prev_ms, turns_prev_new_new_prev=four)
        rec.update(bound_share=b_ms / rec["ms"], tflops=4.0 * D * pairs / rec["ms"] / 1e9)
    print(json.dumps({"flash": rec}))
    return rec


# -- phase 3: paged decode attention ----------------------------------------

def paged_case(pa, name, B, NH, KVH, D, ps, MP, dtype, quant=False, poison=False,
               alibi=False, timed=False, seed=0):
    """Kernel B against its fp32 plain version and the parent's build on
    the same inputs."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    P = B * MP + 1  # + the trash page
    trash = P - 1
    q = torch.randn((B, NH, D), generator=g, device=DEV).to(dtype)
    if quant:
        k_pool = torch.randint(-127, 128, (P, ps, KVH, D), generator=g,
                               device=DEV).to(torch.int8)
        v_pool = torch.randint(-127, 128, (P, ps, KVH, D), generator=g,
                               device=DEV).to(torch.int8)
        k_scale = torch.rand((P, ps, KVH), generator=g, device=DEV) * 0.02 + 0.002
        v_scale = torch.rand((P, ps, KVH), generator=g, device=DEV) * 0.02 + 0.002
    else:
        k_pool = torch.randn((P, ps, KVH, D), generator=g, device=DEV).to(dtype)
        v_pool = torch.randn((P, ps, KVH, D), generator=g, device=DEV).to(dtype)
        k_scale = v_scale = None
    # ragged positions up to the last slot of the table, one at the end
    pos = torch.randint(1, MP * ps, (B,), generator=g, device=DEV, dtype=torch.int32)
    pos[0] = MP * ps - 1
    perm = torch.randperm(P - 1, generator=g, device=DEV)
    table = torch.full((B, MP), trash, dtype=torch.int32, device=DEV)
    n = 0
    for b in range(B):
        used = int(pos[b].item()) // ps + 1
        table[b, :used] = perm[n:n + used].to(torch.int32)
        n += used
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    args = (q, k_pool, v_pool, table, pos)
    kw = dict(k_scale=k_scale, v_scale=v_scale, alibi_slopes=slopes)
    out = pa.paged_decode_attention(*args, **kw)
    again = pa.paged_decode_attention(*args, **kw)
    pools32 = (k_pool, v_pool) if quant else (k_pool.float(), v_pool.float())
    ref = pa.paged_decode_attention_plain(q.float(), *pools32, table, pos, **kw)
    torch.cuda.synchronize()
    err, atol_used, ok = max_err(out, ref, PAGED_TOL[dtype])
    rec = {"case": name, "shape": [B, NH, KVH, D, ps, MP], "dtype": str(dtype)[6:],
           "quant": quant, "alibi": alibi, "positions": pos.tolist(),
           "max_abs_err": err, "atol_used": atol_used, "tol": PAGED_TOL[dtype],
           "resident": (pa.resident_blocks(dtype, quant, D, ps, MP, pa.row_groups(NH // KVH)[1])
                        if D <= 256 else None),
           "n_split": pa.split_count(B, KVH, MP, torch.cuda.get_device_properties(0)
                                     .multi_processor_count, pa.row_groups(NH // KVH)[0],
                                     pa.resident_blocks(dtype, quant, D, ps, MP,
                                                        pa.row_groups(NH // KVH)[1]))
           if D <= 256 else None,
           "row_groups": pa.row_groups(NH // KVH), "chunk": pa.page_chunk(ps),
           "tma": pa.tma_pages(D), "bit_equal_across_calls": torch.equal(out, again)}
    print(json.dumps({"paged_check": rec}))
    check(bool(torch.isfinite(out).all()), f"paged {name}: non-finite output")
    check(ok, f"paged {name}: kernel vs fp32 plain beyond {PAGED_TOL[dtype]} "
          f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    check(rec["bit_equal_across_calls"], f"paged {name}: outputs differ between two calls")
    def new():
        return pa.paged_decode_attention(*args, **kw)

    def prev():
        return BASE.swapped("paged_attention", new)

    if BASE is not None:  # the parent's build on the same inputs: its bits
        same = torch.equal(prev(), out)
        check(same, f"paged {name}: other bits than the parent's build")
        rec["bit_equal_to_previous"] = same
    if poison:
        # NaN in the trash page: the kernel never loads it, so its output
        # is bit-identical to the clean run
        k_pool[trash] = float("nan") if not quant else 0
        v_pool[trash] = float("nan") if not quant else 0
        if quant:
            k_scale[trash] = float("nan")
            v_scale[trash] = float("nan")
        poisoned = pa.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(poisoned, out), f"paged {name}: trash-page NaN reached the output")
        rec["poisoned_trash_bit_identical"] = True
    if timed:
        slots = int((pos.long() + 1).sum().item())
        kv_item = k_pool.element_size()
        nbytes = (2 * slots * KVH * D * kv_item + (2 * slots * KVH * 4 if quant else 0)
                  + 2 * q.numel() * q.element_size()
                  + sum(-(-int(p) // ps) for p in (pos + 1).tolist()) * 4 + B * 4)
        ops = 4.0 * D * slots * NH
        b_ms, b_by = bound(nbytes, ops, dtype)
        S = MP * ps
        vis = (torch.arange(S, device=DEV)[None, :] <= pos.long()[:, None])[:, None, None]
        G = NH // KVH

        def library():  # the gather + SDPA yardstick (bf16 pools only)
            kk = k_pool[table.long()].reshape(B, S, KVH, D).transpose(1, 2)
            vv = v_pool[table.long()].reshape(B, S, KVH, D).transpose(1, 2)
            return sdpa(q[:, :, None], kk, vv, vis, G)

        if BASE is not None:  # the parent's kernel in turns
            rec["previous_ms"], ms, rec["turns_prev_new_new_prev"] = turns(prev, new)
        else:
            ms = device_ms(new)
        if D <= 256 and not quant:
            # every split count on the same inputs, in turns (1, 2, 4, 8, 8,
            # 4, 2, 1): what the rule's pick (``n_split``) is worth
            rule, sweep = pa.split_count, {}
            try:
                for n in (1, 2, 4, 8, 8, 4, 2, 1):
                    pa.split_count = lambda *_, n=n, **__: n
                    sweep.setdefault(n, []).append(device_ms(new))
            finally:
                pa.split_count = rule
            rec["split_sweep_ms"] = {n: sum(t) / len(t) for n, t in sweep.items()}
        rec.update(
            ms=ms, bound_share=b_ms / ms,
            plain_ms=device_ms(lambda: pa.paged_decode_attention_plain(*args, **kw)),
            library_ms=None if quant else device_ms(library),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=ops)
    print(json.dumps({"paged": rec}))
    return rec


def flash_phase(fa):
    """Kernel A at the llama-1b prefill shapes (timed) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        flash_case(fa, "prefill_s512", 1, 512, 512, 32, 8, 64, bf16, timed=True),
        flash_case(fa, "prefill_s1024", 1, 1024, 1024, 32, 8, 64, bf16, timed=True),
        flash_case(fa, "chunk_256_at_512_window_1024", 1, 256, 1024, 32, 8, 64, bf16,
                   q_offset=512, timed=True),
        flash_case(fa, "alibi_d128", 2, 192, 192, 8, 8, 128, bf16, alibi=True),
        flash_case(fa, "fp32_uneven_gqa", 1, 200, 200, 8, 2, 32, fp32),
        flash_case(fa, "fp16_full_d16", 2, 96, 130, 4, 1, 16, fp16, causal=False),
        flash_case(fa, "bf16_d32_valid_k", 2, 100, 160, 4, 2, 32, bf16, causal=False,
                   valid_k=131),
        flash_case(fa, "fp16_chunk_d64", 1, 48, 192, 8, 2, 64, fp16, q_offset=100),
        # fp16 causal (#F4): the training forward and D = 224
        flash_case(fa, "fp16_train_b4_s1024", 4, 1024, 1024, 32, 8, 64, fp16, timed=True),
        flash_case(fa, "fp16_causal_d224", 1, 1024, 1024, 8, 8, 224, fp16, timed=True),
        flash_case(fa, "fp16_causal_d224_gqa_s300", 2, 300, 300, 8, 2, 224, fp16),
        # head dims of phi 2 (80) and gpt-neox 20b (96)
        flash_case(fa, "d80_gqa_s300", 2, 300, 300, 8, 2, 80, bf16),
        flash_case(fa, "d96_chunk_alibi", 1, 100, 357, 4, 4, 96, bf16, q_offset=257,
                   alibi=True),
        flash_case(fa, "fp32_d80_full", 1, 70, 90, 4, 1, 80, fp32, causal=False),
        # falcon-7b's 71 query heads over one KV head, and BERT-base's
        # non-causal training shape
        flash_case(fa, "falcon7b_71to1_s1024", 1, 1024, 1024, 71, 1, 64, bf16, timed=True),
        flash_case(fa, "bert_base_full_b16_s512", 16, 512, 512, 12, 12, 64, bf16,
                   causal=False, timed=True),
        # the training forward (llama-1b, micro-batch 4) and llama-7b's heads
        flash_case(fa, "train_b4_s1024", 4, 1024, 1024, 32, 8, 64, bf16, timed=True),
        flash_case(fa, "llama7b_s1024_d128", 1, 1024, 1024, 32, 32, 128, bf16, timed=True),
        # head dims off 16 and past 128 (zero-filled columns), strided views
        flash_case(fa, "d72_gqa_s300", 2, 300, 300, 8, 2, 72, bf16),
        flash_case(fa, "d160_chunk", 1, 100, 300, 4, 2, 160, bf16, q_offset=200),
        flash_case(fa, "d256_alibi", 1, 260, 260, 4, 4, 256, bf16, alibi=True),
        flash_case(fa, "d100_full", 1, 70, 90, 4, 1, 100, bf16, causal=False),
        flash_case(fa, "fp32_d160", 1, 70, 90, 4, 2, 160, fp32),
        flash_case(fa, "strided_qkv_views", 2, 200, 200, 8, 8, 64, bf16, strided=True),
        # head dims past 256: the runtime-head-dim kernel (causal, and a chunk
        # window with ALiBi), timed at D = 512
        *(flash_case(fa, f"wide_d{D}_{nm}", 1, 150, 150, 4, 2, D, dt)
          for D in (288, 320, 512) for nm, dt in (("bf16", bf16), ("fp32", fp32))),
        *(flash_case(fa, f"wide_d{D}_chunk_alibi", 1, 60, 200, 4, 2, D, bf16, q_offset=140,
                     alibi=True) for D in (288, 320, 512)),
        flash_case(fa, "wide_d512_s1024", 1, 1024, 1024, 8, 8, 512, bf16, timed=True),
    ]


def paged_phase(pa):
    """Kernel B at the llama-1b decode shape (timed) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        paged_case(pa, "decode_b8_ctx1024", 8, 32, 8, 64, 16, 64, bf16, poison=True,
                   timed=True),
        paged_case(pa, "int8_pages", 8, 32, 8, 64, 16, 64, bf16, quant=True, poison=True,
                   timed=True),
        # the decode shapes of the large served models: llama-7b (MHA, 32 KV
        # heads of 128) in bf16 and int8 pages, Mixtral-8x7b (8 KV heads of 128)
        paged_case(pa, "llama7b_b8_ctx1024", 8, 32, 32, 128, 16, 64, bf16, poison=True,
                   timed=True),
        paged_case(pa, "llama7b_int8_pages", 8, 32, 32, 128, 16, 64, bf16, quant=True,
                   poison=True, timed=True),
        paged_case(pa, "mixtral_b8_ctx1024", 8, 32, 8, 128, 16, 64, bf16, poison=True,
                   timed=True),
        paged_case(pa, "alibi_fp32_21_pages", 4, 8, 2, 32, 16, 21, fp32, alibi=True),
        paged_case(pa, "mha_d128_fp16_one_run", 3, 8, 8, 128, 8, 6, fp16),
        # head dims of phi 2 (80) and gpt-neox 20b (96)
        paged_case(pa, "d80_gqa_20_pages", 4, 32, 8, 80, 16, 20, bf16, poison=True),
        paged_case(pa, "int8_d96_alibi", 3, 8, 4, 96, 16, 12, bf16, quant=True, alibi=True),
        # head dims off 16 (rows read in place at 72, tails zero-filled) and past 128
        paged_case(pa, "d72_gqa_20_pages", 4, 32, 8, 72, 16, 20, bf16, poison=True),
        paged_case(pa, "int8_d72", 3, 8, 4, 72, 16, 12, bf16, quant=True),
        paged_case(pa, "d160_alibi", 3, 8, 2, 160, 16, 12, bf16, alibi=True),
        # wide GQA groups (falcon-7b: 71 query heads over one KV head, in row
        # groups), gemma-like 8 rows of 256, fp32 pools past 160 (fewer
        # warps), pages of 128 and 256 slots (staged in chunks of 16)
        paged_case(pa, "falcon7b_71_to_1", 4, 71, 1, 64, 16, 20, bf16, poison=True),
        paged_case(pa, "int8_falcon7b_alibi", 3, 71, 1, 64, 16, 12, bf16, quant=True,
                   alibi=True),
        paged_case(pa, "g8_d256", 3, 16, 2, 256, 16, 12, bf16, poison=True),
        paged_case(pa, "fp32_d256", 3, 4, 2, 256, 16, 12, fp32, alibi=True),
        paged_case(pa, "fp32_d200_g8", 2, 8, 1, 200, 16, 10, fp32),
        paged_case(pa, "ps128_pages", 3, 8, 2, 64, 128, 6, bf16, poison=True),
        paged_case(pa, "int8_ps256_d128", 2, 8, 2, 128, 256, 3, bf16, quant=True, poison=True),
        paged_case(pa, "fp32_ps128_d256", 2, 4, 1, 256, 128, 3, fp32, poison=True),
        # head dims past 256: the runtime-head-dim kernel, bf16 and int8 pages
        *(paged_case(pa, f"wide_d{D}", 3, 8, 2, D, 16, 12, bf16, poison=True)
          for D in (288, 320, 512)),
        *(paged_case(pa, f"wide_int8_d{D}_alibi", 3, 8, 2, D, 16, 12, bf16, quant=True,
                     alibi=True) for D in (288, 320, 512)),
        paged_case(pa, "wide_fp32_d320", 2, 8, 4, 320, 16, 10, fp32),
        paged_case(pa, "wide_d512_b8_ctx1024", 8, 32, 8, 512, 16, 64, bf16, timed=True),
    ]


# -- phase 6: flash-attention backward ---------------------------------------

def flash_bwd_case(fa, name, B, S, NH, KVH, D, dtype, causal=True, alibi=False, timed=False,
                   seed=0):
    """Kernels A' (dq) and A'' (dk, dv) against the plain backward computed
    in fp32 from the same inputs, the same lse and the same delta."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, S, NH, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, KVH, D), generator=g, device=DEV).to(dtype)
    do = torch.randn((B, S, NH, D), generator=g, device=DEV).to(dtype)
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    kw = dict(causal=causal, alibi_slopes=slopes)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = fa._delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), **kw)
    torch.cuda.synchronize()
    G = NH // KVH
    tol = FLASH_BWD_TOL[dtype]
    two_terms = fa.dkv_two_terms(dtype, G, D)
    rec = {"case": name, "shape": [B, S, NH, KVH, D], "dtype": str(dtype)[6:],
           "causal": causal, "alibi": alibi, "tol": tol, "dkv_two_terms": two_terms}
    for nm, out, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err, atol_used, ok = max_err(out, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"] = err, atol_used
        rec[f"{nm}_ref_max_abs"] = want.abs().max().item()
        check(bool(torch.isfinite(out).all()), f"flash bwd {name}: non-finite {nm}")
        check(ok, f"flash bwd {name}: {nm} vs fp32 plain beyond {tol} "
              f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    rec["max_abs_err"] = max(rec[f"{nm}_max_abs_err"] for nm in ("dq", "dk", "dv"))
    if G > 4:
        rec["dkv_within_unscaled_tol"] = True  # held above
    if G > 4 and dtype != torch.float32:
        # the record beside it: SDPA's backward against the same fp32 version
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib = [t.transpose(1, 2) for t in torch.autograd.grad(
            sdpa(qh, kh, vh, None, G, causal), (qh, kh, vh), do.transpose(1, 2))]
        for nm, lg, fp in zip(("dq", "dk", "dv"), lib, ref):
            rec[f"{nm}_library_atol_needed"] = max_err(lg, fp, tol)[1]
    if dtype != torch.float32:
        # no atomics: a second call gives the same bits
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in ((dq, dq2), (dk, dk2), (dv, dv2)))
        check(same, f"flash bwd {name}: gradients differ between two calls")
        rec["bit_equal_across_calls"] = same

    def new_bwd():
        return (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))

    def previous(fn):
        # the parent's library has no two-term code: its one-term A''
        keep, fa.TWO_TERM_GROUP = fa.TWO_TERM_GROUP, 1 << 30
        try:
            return BASE.swapped("flash_attention_bwd", fn)
        finally:
            fa.TWO_TERM_GROUP = keep

    def prev_bwd():
        return previous(new_bwd)

    if BASE is not None:
        if two_terms:  # other bits than the parent's one-term kernel, by design
            prev = prev_bwd()
            torch.cuda.synchronize()
            rec["dq_bit_equal_to_previous"] = bool(torch.equal(prev[0], dq))
            check(rec["dq_bit_equal_to_previous"], f"flash bwd {name}: dq changed")
            rec["previous_dkv_max_abs_err"] = max(max_err(x, want, tol)[0] for x, want in
                                                  zip(prev[1:], ref[1:]))
        else:
            same_as_previous(rec, f"flash bwd {name}", prev_bwd(), (dq, dk, dv))
    print(json.dumps({"flash_bwd_check": rec}))
    if timed and BASE is not None and dtype != torch.float32:
        p_ms, n_ms, four = turns(prev_bwd, new_bwd)
        rec.update(previous_dq_dkv_ms=p_ms, turns_dq_dkv_prev_new_new_prev=four)
        if two_terms:  # A'' alone: the one-term parent against two terms

            def new_dkv():
                return fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

            p_ms, n_ms, four = turns(lambda: previous(new_dkv), new_dkv)
            rec.update(previous_dkv_ms=p_ms, turns_dkv_prev_new_new_prev=four,
                       dkv_ms_in_turns=n_ms)
    if timed:
        rows = torch.arange(S, device=DEV)
        vis = (rows[:, None] >= rows[None, :]) if causal else \
            torch.ones((S, S), dtype=torch.bool, device=DEV)
        pairs = int(vis.sum().item()) * B * NH
        item = q.element_size()
        io = (2 * q.numel() + k.numel() + v.numel()) * item + 2 * lse.numel() * 4  # q dO k v lse delta
        dq_b, dq_by = bound(io + q.numel() * item, 6.0 * D * pairs, dtype)
        dkv_b, dkv_by = bound(io + 2 * k.numel() * item, 8.0 * D * pairs, dtype)
        all_b, all_by = bound(io + o.numel() * item + (q.numel() + 2 * k.numel()) * item,
                              10.0 * D * pairs, dtype)
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        doh = do.transpose(1, 2)
        G = NH // KVH
        mask = None
        if alibi:
            rel = (rows[:, None] - rows[None, :]).float()
            mask = torch.where(vis, -slopes[:, None, None] * rel, float("-inf")).to(dtype)
        sdpa_causal = causal and not alibi

        def lib_fwd():
            return sdpa(qh, kh, vh, mask, G, sdpa_causal)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

        with torch.no_grad():
            lib_f = device_ms(lib_fwd)
        lib_fb = device_ms(lib_fwd_bwd)
        dq_ms = device_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
        dkv_ms = device_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        rec.update(
            dq_ms=dq_ms, dkv_ms=dkv_ms, dq_dkv_ms=dq_ms + dkv_ms,
            plain_ms=device_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                               iters=5, warmup=2),
            library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb, library_fwd_ms=lib_f,
            dq_bound_ms=dq_b, dq_bound_by=dq_by, dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
            dq_bound_share=dq_b / dq_ms, dkv_bound_share=dkv_b / dkv_ms,
            dq_tflops=6.0 * D * pairs / dq_ms / 1e9, dkv_tflops=8.0 * D * pairs / dkv_ms / 1e9,
            bwd_bound_ms=all_b, bwd_bound_by=all_by, pairs=pairs)
    print(json.dumps({"flash_bwd": rec}))
    return rec


def flash_bwd_strided_case(fa, B=2, S=200, NH=8, KVH=2, D=64, dtype=torch.bfloat16):
    """The backward kernels read q, k, v and dO through their strides (TMA
    maps): [B, H, S, D] tensors viewed as [B, S, H, D] give the same bits
    as their contiguous copies."""
    g = torch.Generator(device=DEV).manual_seed(5)
    q, do = (torch.randn((B, NH, S, D), generator=g, device=DEV).to(dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn((B, KVH, S, D), generator=g, device=DEV).to(dtype).transpose(1, 2)
            for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    want = (fa.flash_attention_bwd_dq(qc, kc, vc, doc, lse, delta),
            *fa.flash_attention_bwd_dkv(qc, kc, vc, doc, lse, delta))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    check(same, "flash bwd: strided views give other bits than their contiguous copies")
    rec = {"case": "strided_views", "shape": [B, S, NH, KVH, D], "bit_equal_to_contiguous": same}
    print(json.dumps({"flash_bwd_check": rec}))
    return rec


def flash_bwd_phase(fa):
    """Kernels A' and A'' at the llama-1b training shape (timed) and corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        flash_bwd_case(fa, "train_b4_s1024", 4, 1024, 32, 8, 64, bf16, timed=True),
        flash_bwd_case(fa, "gqa4_uneven_s200", 2, 200, 8, 2, 64, bf16),
        flash_bwd_case(fa, "alibi_d128", 1, 192, 8, 8, 128, bf16, alibi=True),
        flash_bwd_case(fa, "fp16_full_d32_s130", 2, 130, 4, 1, 32, fp16, causal=False),
        flash_bwd_case(fa, "fp32_gqa_s200_d16", 1, 200, 8, 2, 16, fp32),
        flash_bwd_case(fa, "fp32_alibi_full_s100", 2, 100, 4, 4, 64, fp32, causal=False,
                       alibi=True),
        # head dims of phi 2 (80) and gpt-neox 20b (96), ragged S
        flash_bwd_case(fa, "d80_gqa_s300", 2, 300, 8, 2, 80, bf16),
        flash_bwd_case(fa, "d96_full_alibi_s257", 1, 257, 4, 4, 96, bf16, causal=False,
                       alibi=True),
        flash_bwd_case(fa, "fp16_d80_full_s130", 1, 130, 4, 2, 80, fp16, causal=False),
        # fp16 causal (#F4): llama-1b's training shape, and D = 80 at S = 130
        flash_bwd_case(fa, "fp16_train_b4_s1024", 4, 1024, 32, 8, 64, fp16, timed=True),
        flash_bwd_case(fa, "fp16_d80_causal_s130", 1, 130, 4, 2, 80, fp16),
        # head dims off 16 (zero columns) and past 128 (halves of the columns)
        flash_bwd_case(fa, "d72_gqa_s300", 2, 300, 8, 2, 72, bf16),
        flash_bwd_case(fa, "d160_alibi_s200", 1, 200, 4, 2, 160, bf16, alibi=True),
        flash_bwd_case(fa, "fp32_d160_s100", 1, 100, 4, 2, 160, fp32),
        # llama-7b's heads
        flash_bwd_case(fa, "llama7b_b2_s2048_d128", 2, 2048, 32, 32, 128, bf16, timed=True),
        # falcon-7b's 71:1 grouping (A'' sums dK/dV over all 71 query heads)
        # and BERT-base's non-causal training shape
        flash_bwd_case(fa, "falcon7b_71to1_s1024", 1, 1024, 71, 1, 64, bf16, timed=True),
        flash_bwd_case(fa, "bert_base_full_b16_s512", 16, 512, 12, 12, 64, bf16,
                       causal=False, timed=True),
        # head dims past 256: the runtime-head-dim kernels
        *(flash_bwd_case(fa, f"wide_d{D}_{nm}", 1, 150, 4, 2, D, dt, causal=causal)
          for D in (288, 320, 512)
          for nm, dt, causal in (("bf16", bf16, True), ("fp32_full", fp32, False))),
        flash_bwd_case(fa, "wide_d320_alibi_full", 1, 130, 4, 4, 320, bf16, causal=False,
                       alibi=True),
        flash_bwd_case(fa, "wide_d512_s1024", 1, 1024, 8, 8, 512, bf16, timed=True),
    ] + [flash_bwd_strided_case(fa)]


# -- phase 7: fused Adam -----------------------------------------------------

def fused_adamw_library(p, g, m, v, step_t, lr, wd):
    """torch._fused_adamw_ on one leaf (yardstick; fp32 moments only)."""
    torch._fused_adamw_([p], [g], [m], [v], [], [step_t], lr=lr, beta1=0.9, beta2=0.999,
                        weight_decay=wd, eps=1e-8, amsgrad=False, maximize=False)


def adam_case(fadam, name, n, mu_dtype=torch.float32, offset=0, adam_w_mode=True, wd=0.1,
              timed=False, seed=0):
    """Kernel C against its plain version on the same inputs; ``offset``
    starts the leaf one element into a buffer (unaligned: the scalar loop)."""
    g_ = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(scale=1.0, dt=torch.float32):
        return (torch.randn((n + offset,), generator=g_, device=DEV) * scale)[offset:].to(dt)

    p, g = rnd(), rnd(1e-2)
    m, v = rnd(1e-3, mu_dtype), rnd(1e-4).abs()
    scalars = torch.tensor([3.0, 1e-4], device=DEV)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd, adam_w_mode=adam_w_mode)
    ref = [t.clone() for t in (p, g, m, v)]
    fadam.fused_adam_update(p, g, m, v, scalars, **hyper)
    fadam.fused_adam_plain(*ref, scalars, **hyper)
    torch.cuda.synchronize()
    rec = {"case": name, "n": n, "mu_dtype": str(mu_dtype)[6:], "offset": offset,
           "adam_w_mode": adam_w_mode, "weight_decay": wd}
    for nm, out, want in (("p", p, ref[0]), ("m", m, ref[2]), ("v", v, ref[3])):
        tol = ADAM_TOL[out.dtype]
        err, atol_used, ok = max_err(out, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"], rec[f"{nm}_tol"] = err, atol_used, tol
        check(bool(torch.isfinite(out).all()), f"adam {name}: non-finite {nm}")
        check(ok, f"adam {name}: {nm} vs plain beyond {tol} (max abs {err:.3g})")
    rec["max_abs_err"] = max(rec[f"{nm}_max_abs_err"] for nm in "pmv")
    print(json.dumps({"adam_check": rec}))
    if timed:
        nbytes = n * (20 + 2 * m.element_size())  # p, v read and written; g read; m both
        b_ms, b_by = bound(nbytes, 20.0 * n, torch.float32)
        lib = None
        if mu_dtype == torch.float32:
            lp, lg, lm, lv = (t.clone() for t in (p, g, m, v))
            step_t = torch.tensor(3.0, device=DEV)
            lib = device_ms(lambda: fused_adamw_library(lp, lg, lm, lv, step_t, 1e-4, wd))
        rec.update(ms=device_ms(lambda: fadam.fused_adam_update(p, g, m, v, scalars, **hyper)),
                   plain_ms=device_ms(lambda: fadam.fused_adam_plain(*ref, scalars, **hyper)),
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    print(json.dumps({"adam": rec}))
    return rec


def adam_phase(fadam):
    """Kernel C on llama-1b's embedding leaf (timed) and odd corners."""
    return [
        adam_case(fadam, "embed_tok_65.5M", 32000 * 2048, timed=True),
        adam_case(fadam, "embed_tok_65.5M_mu_bf16", 32000 * 2048, mu_dtype=torch.bfloat16,
                  timed=True),
        adam_case(fadam, "odd_1000003", 1_000_003),
        adam_case(fadam, "odd_unaligned_adam_l2", 5503, offset=1, adam_w_mode=False),
        adam_case(fadam, "norm_2048_mu_bf16_unaligned", 2048, mu_dtype=torch.bfloat16,
                  offset=2, wd=0.0),
    ]


# -- phase 8: training ---------------------------------------------------------

TRAIN_SEQ, TRAIN_MICRO = 1024, 4


def train_config(gas=1, **extra):
    """The ds-config of a llama rung of the JAX bench (bench.py:265-280):
    bf16, ZeRO stage 1, AdamW with the fused kernel, clipping 1.0, fp32
    gradient accumulation."""
    cfg = {"train_micro_batch_size_per_gpu": TRAIN_MICRO, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-4, "weight_decay": 0.1, "fused_kernel": True}},
           "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
           "gradient_clipping": 1.0, "data_types": {"grad_accum_dtype": "fp32"}}
    cfg.update(extra)
    return cfg


def zero_train_counters(fa, fadam):
    for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
              fadam.fused_adam_update):
        c.launches = 0


def read_train_counters(fa, fadam):
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "fused_adam": fadam.fused_adam_update.launches}


def timed_steps(engine, batch, steps):
    """``steps`` train_batch calls, each timed between synchronisations:
    (losses as device tensors, ms per step, the host syncs PyTorch's sync
    debug mode saw inside the calls — a prototype that, in PyTorch's own
    words, does not yet detect every synchronizing operation)."""
    losses, step_ms, syncs = [], [], 0
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                losses.append(engine.train_batch(batch))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs += sum("called a synchronizing CUDA operation" in str(w.message)
                     for w in caught)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    return losses, step_ms, syncs


def train_phase(fa, fadam, steps=8, gas2_steps=2):
    """llama-1b at full width and depth through initialize -> train_batch:
    ``steps`` steps at gas 1 on one seeded batch (the loss must fall and
    stay finite), then ``gas2_steps`` at gas 2.  Counters are zeroed just
    before each drive and read just after."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.models.transformer import flops_per_token

    model = llama_model("1b", max_seq_len=TRAIN_SEQ)
    cfg = model.config
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(), seed=0)
    init_s = time.perf_counter() - t0
    n_leaves = len(engine._master)
    n_params = sum(p.numel() for p in engine._master)
    check(engine.device.type == "cuda", "training engine device is not cuda")
    check(all(p.is_cuda and p.dtype == torch.float32 for p in engine._master),
          "master params are not fp32 on cuda")
    check(all(p.dtype == torch.bfloat16 for p in engine._compute_leaves),
          "compute copy is not bf16")
    g = torch.Generator(device=DEV).manual_seed(123)
    batch = torch.randint(0, cfg.vocab_size, (1, TRAIN_MICRO, TRAIN_SEQ), generator=g,
                          device=DEV)
    zero_train_counters(fa, fadam)
    losses, step_ms, syncs = timed_steps(engine, batch, steps)
    launches = read_train_counters(fa, fadam)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    check(all(map(math.isfinite, losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall over {steps} steps: {losses}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * steps,
              f"train: {k} launches {launches[k]} != {L} layers x {steps} micro-steps")
    check(launches["fused_adam"] == n_leaves * steps,
          f"train: fused_adam launches {launches['fused_adam']} != {n_leaves} x {steps}")
    check(syncs == 0, f"train: {syncs} host syncs inside bf16 train_batch calls")
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = TRAIN_MICRO * TRAIN_SEQ
    fpt = flops_per_token(cfg, TRAIN_SEQ)
    prof = profile_window(lambda: engine.train_batch(batch), 1, top_n=10,
                          groups={"flash_bwd_dq": "flash_bwd_dq_wgmma",
                                  "flash_bwd_dkv": "flash_bwd_dkv_wgmma"})
    rec = {"model": "llama-1b", "layers": L, "params": n_params, "leaves": n_leaves,
           "seq": TRAIN_SEQ, "micro_batch": TRAIN_MICRO, "dtype": "bf16", "init_s": init_s,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / (med / 1e3), "flops_per_token": fpt,
           "mfu": fpt * tokens / (med / 1e3) / PEAK_OPS[torch.bfloat16],
           "peak_mem_gb": peak_gb, "launches": launches, "host_syncs": syncs, "profile": prof,
           "grad_norm": engine.get_global_grad_norm(), "lr": engine.get_lr()[0]}
    del engine, losses
    torch.cuda.empty_cache()

    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(gas=2), seed=0)
    batch2 = torch.randint(0, cfg.vocab_size, (2, TRAIN_MICRO, TRAIN_SEQ), generator=g,
                           device=DEV)
    zero_train_counters(fa, fadam)
    gl, gms, syncs2 = timed_steps(engine, batch2, gas2_steps)
    l2 = read_train_counters(fa, fadam)
    gl = [float(x) for x in gl]
    check(all(map(math.isfinite, gl)), f"train gas 2: non-finite loss {gl}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(l2[k] == L * 2 * gas2_steps, f"train gas 2: {k} launches {l2[k]} != "
              f"{L} x 2 micro-steps x {gas2_steps}")
    check(l2["fused_adam"] == n_leaves * gas2_steps,
          f"train gas 2: fused_adam launches {l2['fused_adam']}")
    check(syncs2 == 0, f"train gas 2: {syncs2} host syncs inside train_batch calls")
    rec["gas2"] = {"losses": gl, "step_ms": gms, "launches": l2, "host_syncs": syncs2}
    del engine
    torch.cuda.empty_cache()
    print(json.dumps({"train": rec}))
    return rec


# -- phase 9: card vs CPU training parity --------------------------------------

#: Card vs CPU at llama-1b width.  fp32: both sides fp32 end to end (no
#: TF32), summed in other orders by cuBLAS and the CPU GEMMs and by the
#: kernels and the plain attention.  A weight whose gradient is near Adam's
#: eps (1e-8) takes a step that depends on the gradient's last digits, up
#: to lr per step: observed 3.4e-5 after 3 steps at lr 1e-4, limit 1e-4.
#: fp16: every op rounds to 11 bits, and Adam's near-sign step can move a
#: weight by up to 2 lr per applied step (observed 3.7e-4 after 2 steps).
TRAIN_PARITY_TOL = {"fp32": {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4},
                    "fp16": {"loss": 2e-3, "grad_norm": 2e-2, "params": 1e-3}}


def movement_parity(card, cpu, init) -> dict:
    """Card against CPU masters after a run from ``init``: the L2 norm of
    the difference over that of the CPU's movement, over all leaves and the
    largest in one leaf, and the share of elements past ``OPTIMIZER_TOL``'s
    limit (atol + rtol x the leaf's largest movement)."""
    atol, rtol = OPTIMIZER_TOL
    d2 = m2 = 0.0
    worst, past, total = 0.0, 0, 0
    for a, b, c in zip(card, cpu, init):
        d, mv = (a.cpu() - b).double(), (b - c).double()
        dn, mn = float(d.pow(2).sum()), float(mv.pow(2).sum())
        d2, m2 = d2 + dn, m2 + mn
        worst = max(worst, math.sqrt(dn / mn) if mn > 0 else (math.inf if dn > 0 else 0.0))
        past += int((d.abs() > atol + rtol * float(mv.abs().max())).sum())
        total += d.numel()
    return {"params_rel_norm": math.sqrt(d2 / m2) if m2 > 0 else math.inf,
            "params_leaf_rel_norm": worst, "params_past_tight": past,
            "params_past_tight_share": past / total}


def train_parity(model, params, cases, label):
    """``model`` on the card and on the CPU from the same ``params`` and
    batches, for each case (name, ds-config extra, steps, B, S); fp16 runs
    until one overflow step has been skipped and two applied (at most
    ``steps``).  Loss, grad norm, loss scale and skipped steps per step,
    then the master params, against ``TRAIN_PARITY_TOL``."""
    import deepspeed_tpu_torch

    rng = torch.Generator().manual_seed(8)
    out = {}
    for name, extra, max_steps, B, S in cases:
        ds = train_config(**extra)
        ds.pop("bf16")
        ds["train_micro_batch_size_per_gpu"] = B
        engines = {dev: deepspeed_tpu_torch.initialize(model=model, config=dict(ds),
                                                       model_parameters=params, device=dev)[0]
                   for dev in ("cuda", "cpu")}
        tol = TRAIN_PARITY_TOL[name]
        rec = {"batch": [B, S], "tol": tol, "per_step": [], "seconds": dict.fromkeys(engines, 0.0)}
        init = [p.detach().clone() for p in engines["cpu"]._master]
        for _ in range(max_steps):
            ids = torch.randint(0, model.config.vocab_size, (1, B, S), generator=rng)
            row = {}
            for dev, e in engines.items():
                t0 = time.perf_counter()
                loss = float(e.train_batch(ids))
                rec["seconds"][dev] += time.perf_counter() - t0
                row[dev] = {"loss": loss, "grad_norm": e.get_global_grad_norm(),
                            "loss_scale": e.loss_scale(), "skipped": e.skipped_steps,
                            "applied": int(e.state.step)}
            c, h = row["cuda"], row["cpu"]
            check(c["loss_scale"] == h["loss_scale"] and c["skipped"] == h["skipped"],
                  f"{label} {name}: loss scale / skipped differ: {row}")
            check(abs(c["loss"] - h["loss"]) <= tol["loss"] * abs(h["loss"]),
                  f"{label} {name}: loss {c['loss']} vs {h['loss']}")
            if math.isfinite(h["grad_norm"]):
                check(abs(c["grad_norm"] - h["grad_norm"]) <= tol["grad_norm"] * h["grad_norm"],
                      f"{label} {name}: grad norm {c['grad_norm']} vs {h['grad_norm']}")
            else:
                check(not math.isfinite(c["grad_norm"]), f"{label} {name}: {row}")
            rec["per_step"].append(row)
            if name == "fp16" and c["skipped"] >= 1 and c["applied"] >= 2:
                break
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(
            engines["cuda"]._master, engines["cpu"]._master))
        rec["params_max_abs_diff"] = diff
        if "params" in tol:
            check(diff <= tol["params"], f"{label} {name}: master params differ by {diff}")
        else:
            rec.update(movement_parity(engines["cuda"]._master, engines["cpu"]._master, init))
            check(rec["params_rel_norm"] <= tol["params_rel_norm"] and
                  rec["params_leaf_rel_norm"] <= tol["params_leaf_rel_norm"],
                  f"{label} {name}: master params differ: {rec}")
        rec["steps"] = len(rec["per_step"])
        if name == "fp16":
            check(engines["cuda"].skipped_steps >= 1 and int(engines["cuda"].state.step) >= 2,
                  f"{label} fp16: wanted an overflow step and two applied: {rec}")
        out[name] = rec
        del engines
        torch.cuda.empty_cache()
    print(json.dumps({label: out}))
    return out


@contextlib.contextmanager
def cpu_fp16_products_in_fp32():
    """The CPU reference's fp16 matrix products taken in fp32 and rounded
    once to fp16, as PyTorch's CPU fp16 GEMM computes them; on some builds
    that GEMM takes a slow reference path, which set the phase's time.
    Products on the card, and in other dtypes, go through the model's own
    ``_mm``."""
    from deepspeed_tpu_torch.models import transformer

    mm = transformer._mm

    def cpu_mm(cfg, x, w):
        if x.dtype == torch.float16 and x.device.type == "cpu" and isinstance(w, torch.Tensor):
            return (x.float() @ w.float()).to(torch.float16)
        return mm(cfg, x, w)

    transformer._mm = cpu_mm
    try:
        yield
    finally:
        transformer._mm = mm


def train_parity_phase():
    """A 2-layer llama-1b-width model on the card and on the CPU from the
    same weights and batches: 3 fp32 steps; then fp16 from an initial scale
    of 2^20 with hysteresis 1, until one overflow step has been skipped and
    two steps applied (at most 12).  The CPU side's fp16 products run
    through ``cpu_fp16_products_in_fp32``."""
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=256, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    with cpu_fp16_products_in_fp32():
        return train_parity(model, params, (
            ("fp32", {}, 3, 2, 128),
            ("fp16", {"fp16": {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}},
             12, 1, 64)), "train_parity")


def moe_train_parity_phase():
    """A 2-layer Mixtral-8x160m-width model (dropless: G, G' and G'' on the
    card, their plain versions on the CPU) on the card and on the CPU from
    the same weights and batches: 3 fp32 steps."""
    from deepspeed_tpu_torch.models.mixtral import mixtral_model

    model = mixtral_model("8x160m", max_seq_len=256, n_layers=2, moe_drop_tokens=False)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    return train_parity(model, params, (("fp32", {}, 3, 2, 128),), "moe_train_parity")


# -- phase 4: the engine -----------------------------------------------------

def profile_window(fn, steps: int, top_n: int = 8, groups=None):
    """Run ``fn`` ``steps`` times under torch.profiler: wall and device-busy
    ms per step, the device's idle share, and the top kernels by device
    time (None where the profiler recorded no device time).  ``groups``
    (name -> a fragment of kernel names) adds each group's device ms per
    step and its share of the device time."""
    from torch.profiler import ProfilerActivity

    busy_us, wall_us, dev = _profiled_us(
        fn, steps, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:top_n]
    rec = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3 if dev else None,
           "device_idle_share": 1.0 - busy_us / wall_us if dev else None,
           "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / steps / 1e3
                                       for e in top}}
    for name, frag in (groups or {}).items():
        us = sum(e.self_device_time_total for e in dev if frag in e.key)
        rec[f"{name}_ms_per_step"] = us / steps / 1e3 if dev else None
        rec[f"{name}_share_of_device"] = us / busy_us if dev and busy_us else None
    return rec


def profile_steps(eng, requests, warm_steps: int, steps: int, groups=None):
    """Queue ``requests``, run ``warm_steps`` engine steps, then profile the
    next ``steps`` (``groups`` as in :func:`profile_window`), with the
    decode tokens an engine step emitted; the engine is run dry
    afterwards."""
    for r in requests:
        eng.put(r)
    for _ in range(warm_steps):
        eng.step()
    before = eng.stats()["decode_tokens"]
    rec = profile_window(eng.step, steps, groups=groups)
    # every window ran ``steps`` engine steps: decode tokens per step
    rec["decode_tokens_per_step"] = ((eng.stats()["decode_tokens"] - before)
                                     / (PROFILER_WINDOWS * steps))
    while eng.has_work():
        eng.step()
    return rec


def drive(eng, requests, fa, pa, wq=None, gmm=None):
    """Zero the launch counters (kernel W's and G's too when ``wq`` or
    ``gmm`` is given), serve ``requests`` to completion through put/step,
    read the counters.  Returns the phase record."""
    fa.flash_attention_fwd.launches = 0
    pa.paged_decode_attention.launches = 0
    if wq is not None:
        wq.wq_matmul.launches = 0
    if gmm is not None:
        gmm.grouped_matmul.launches = 0
    before = eng.stats()
    t_put, first, streams, reasons, step_ms = {}, {}, {}, {}, []
    for r in requests:
        uid = eng.put(r)
        t_put[uid] = time.perf_counter()
        streams[uid] = []
    t0 = time.perf_counter()
    while eng.has_work():
        ts = time.perf_counter()
        out = eng.step()
        now = time.perf_counter()
        step_ms.append((now - ts) * 1e3)
        for uid, rec in out.items():
            if rec["tokens"] and uid not in first:
                first[uid] = now - t_put[uid]
            streams[uid] += rec["tokens"]
            if rec["done"]:
                reasons[uid] = rec["finish_reason"]
    wall = time.perf_counter() - t0
    launches = {"flash": fa.flash_attention_fwd.launches,
                "paged": pa.paged_decode_attention.launches}
    if wq is not None:
        launches["wq_matmul"] = wq.wq_matmul.launches
    if gmm is not None:
        launches["grouped_matmul"] = gmm.grouped_matmul.launches
    st = {k: v - before[k] for k, v in eng.stats().items()}
    ttft = sorted(first.values())
    return {"streams": streams, "reasons": reasons, "launches": launches, "stats": st,
            "ttft_mean_s": sum(ttft) / len(ttft), "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_max_s": ttft[-1], "wall_s": wall, "steps": len(step_ms),
            "mean_step_ms": sum(step_ms) / len(step_ms),
            "prefill_tok_per_s": st["prefill_computed_tokens"] / st["prefill_seconds"],
            "decode_tok_per_s": st["decode_tokens"] / st["decode_seconds"]}


def pattern_prompts(rng, lengths, vocab):
    """Prompts of the given lengths, each a random pattern of 8 to 64
    tokens repeated: n-gram drafts then land."""
    out = []
    for n in lengths:
        period = int(torch.randint(8, 65, (1,), generator=rng))
        pat = torch.randint(0, vocab, (period,), generator=rng).tolist()
        out.append((pat * (n // period + 1))[:n])
    return out


def stage_idle(eng):
    """Stage every decode slot inactive (budgets 0), so that a replay
    outside the engine's step writes only the trash page."""
    B = eng.block.max_seqs
    eng._programs.stage(act=[0] * B, budgets=[0] * B)


def replay_kernels(eng, key):
    """{kernel name: launches} the profiler saw in one replay of program
    ``key`` with every slot idle."""
    stage_idle(eng)
    return profiled_kernels(lambda: eng._programs.run(key))


def count_named(names: dict, frag: str) -> int:
    """Launches of the kernels whose names hold ``frag`` (a K-split's
    reduction kernel, part of one wrapper launch, left out)."""
    return sum(n for k, n in names.items() if frag in k and "reduce" not in k)


def eager_decode_check(eng, prompts):
    """One captured decode step against an eager ``paged_decode`` on cloned
    pools: 8 short requests are admitted and prefilled (step 1), the pools
    are cloned, step 2 replays the decode program, and the eager program
    reruns step 2's staged inputs on the clone; the greedy tokens must be
    equal.  Returns the record."""
    from deepspeed_tpu_torch.inference.v2 import RaggedRequest
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_decode

    progs = eng._programs
    uids = [eng.put(RaggedRequest(prompt_ids=p[:64], max_new_tokens=4))
            for p in prompts[:eng.block.max_seqs]]
    eng.step()
    slot_of = {s.uid: s.slot for s in eng._slots if s is not None}
    clone = {k: v.clone() for k, v in eng._pools.items()}
    out = eng.step()
    f = {n: torch.from_numpy(progs.staging[o:o + m].copy()).to(DEV)
         for n, (o, m) in progs._off.items()}
    act = f["act"] != 0
    logits, _ = paged_decode(eng.cfg, eng.params, clone, f["last"].long(), f["pos"],
                             f["table"].view(progs.B, progs.MP), act)
    eager = torch.argmax(logits.float(), dim=-1).tolist()
    got = {slot_of[u]: out[u]["tokens"][0] for u in uids if u in out}
    while eng.has_work():
        eng.step()
    same = all(eager[slot] == tok for slot, tok in got.items())
    check(len(got) == len(uids) and same,
          f"captured decode: tokens {got} differ from eager paged_decode {eager}")
    return {"rows": len(got), "identical_to_eager": same}


#: the serving runs of llama-1b: the decode program captured (whole-prompt
#: and chunked prefill), the 8-step program, n-gram and draft speculation
ENGINE_RUNS = {"whole_prompt": {}, "chunked_256": {"prefill_chunk": 256},
               "horizon_8": {"decode_horizon": 8},
               "spec_ngram": {"speculative": {"mode": "ngram", "k": 4}},
               "spec_draft": {"speculative": {"mode": "draft", "k": 4, "draft_model": "tiny"}}}


def engine_phase(fa, pa):
    import gc

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048)
    L = model.config.n_layers
    rng = torch.Generator().manual_seed(1234)
    lengths = [16, 900] + torch.randint(17, 900, (10,), generator=rng).tolist()
    prompts = pattern_prompts(rng, lengths, model.config.vocab_size)
    results, params = {}, None
    for mode, extra in ENGINE_RUNS.items():
        cfg = RaggedInferenceConfig.from_dict(dict(
            dtype="bf16", page_size=16, max_seqs=8, max_pages_per_seq=64, num_pages=576,
            **extra))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngineV2(model, cfg, params=params, seed=0)
        init_s = time.perf_counter() - t0
        params = eng.params
        check(eng.device.type == "cuda", "engine device is not cuda")
        check(all(p.is_cuda and p.dtype == torch.bfloat16 for p in eng.params.parameters()),
              "params are not bf16 on cuda")
        check(all(t.is_cuda for t in eng._pools.values()), "KV pools are not on cuda")
        draft = eng._proposer if mode == "spec_draft" else None
        draft_L = draft.cfg.n_layers if draft is not None else 0
        # warm-up (allocator, the graphs' first replays): one short request
        eng.generate_all([RaggedRequest(prompt_ids=prompts[0][:32], max_new_tokens=9)])
        forwards0 = draft.forwards if draft is not None else 0
        d0 = dict(eng._dstats)
        rec = drive(eng, [RaggedRequest(prompt_ids=p, max_new_tokens=32) for p in prompts],
                    fa, pa)
        st = rec["stats"]
        ds = {k: v - d0[k] for k, v in eng._dstats.items()}
        rec["decode_stats"] = ds
        rec["decode_tokens_per_host_sync"] = ds["decode_tokens"] / ds["decode_host_syncs"]
        rec["decode_tokens_per_invocation"] = (ds["decode_tokens"]
                                               / ds["decode_model_invocations"])
        rec["spec_acceptance_rate"] = (ds["spec_accepted_tokens"] / ds["spec_proposed_tokens"]
                                       if ds["spec_proposed_tokens"] else None)
        check(len(rec["reasons"]) == len(prompts), f"{mode}: {len(rec['reasons'])} of "
              f"{len(prompts)} requests finished")
        check(all(r == "length" for r in rec["reasons"].values()), f"{mode}: {rec['reasons']}")
        check(all(len(s) == 32 for s in rec["streams"].values()), f"{mode}: stream lengths")
        calls = st["prefill_calls"] + st["prefill_chunk_calls"]
        forwards = (draft.forwards - forwards0) if draft is not None else 0
        rec["draft_forwards"] = forwards
        check(calls > 0 and rec["launches"]["flash"] == L * calls + draft_L * forwards,
              f"{mode}: flash launches {rec['launches']['flash']} != {L} x {calls} prefill "
              f"calls + {draft_L} x {forwards} draft forwards")
        # every decode body a program ran launched kernel B on every layer
        check(st["decode_device_steps"] > 0
              and rec["launches"]["paged"] == L * st["decode_device_steps"],
              f"{mode}: paged launches {rec['launches']['paged']} != {L} x "
              f"{st['decode_device_steps']} decode bodies")
        if mode == "horizon_8":
            check(rec["decode_tokens_per_host_sync"] > 1.0,
                  f"{mode}: {rec['decode_tokens_per_host_sync']} tokens per host sync")
        if mode.startswith("spec"):
            check(ds["spec_verify_calls"] > 0, f"{mode}: no verify call")
        rec["init_s"] = init_s
        rec["graphs"] = [str(k) for k in eng._programs.keys]
        if mode in ("whole_prompt", "horizon_8", "spec_ngram"):
            # 8 slots decoding 64-token prompts (128 new tokens each): wall
            # and device time per engine step, and decode tokens per step
            rec["decode_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=p[:64], max_new_tokens=128)
                      for p in prompts[:cfg.max_seqs]], warm_steps=2, steps=4,
                groups={"paged": "paged_decode"})
        if mode == "whole_prompt":
            rec["prefill_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=prompts[1], max_new_tokens=1)],
                warm_steps=0, steps=1)
            rec["eager_check"] = eager_decode_check(eng, prompts)
            names = replay_kernels(eng, "decode")
            rec["replay_kernels"] = names
            check(count_named(names, "paged_decode") == L,
                  f"{mode}: the profiler saw {names} in one decode replay, not {L} "
                  "paged_decode kernels")
        if mode == "horizon_8":
            rec["replay_b_launches"] = horizon_replay_check(eng, prompts, L)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        results[mode] = rec
        print(json.dumps({"engine": mode, **{k: v for k, v in rec.items()
                                             if k not in ("streams", "reasons")}}))
        eng.close()
        del eng, draft
        gc.collect()
        torch.cuda.empty_cache()
    # greedy streams: the 8-step program emits the single-step program's
    # tokens (the same body, the same kernels); speculation's verify
    # attends through the gather path, whose bf16 roundings differ from
    # kernel B's, so its agreement is reported here and held in fp32
    # (decode_parity_phase)
    base = results["whole_prompt"]["streams"]
    check(results["horizon_8"]["streams"] == base,
          "horizon 8: greedy streams differ from the single-step program's")
    for mode in results:
        results[mode]["streams_equal_to_whole_prompt"] = sum(
            results[mode]["streams"][u] == base[u] for u in base)
    for mode in results:
        results[mode].pop("streams")
    print(json.dumps({"engine_streams_equal_to_whole_prompt": {
        m: r["streams_equal_to_whole_prompt"] for m, r in results.items()}}))
    return results


def horizon_replay_check(eng, prompts, L):
    """Kernel B inside the 8-step program's replays, by the profiler's
    kernel names: over a window of engine steps, L x (decode bodies run)
    paged_decode kernels (the fullest of ``PROFILER_WINDOWS`` windows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.v2 import RaggedRequest

    best = None
    for _ in range(PROFILER_WINDOWS):
        for p in prompts[:eng.block.max_seqs]:
            eng.put(RaggedRequest(prompt_ids=p[:64], max_new_tokens=48))
        eng.step()  # prefill, and the first dispatch
        before = eng.stats()["decode_device_steps"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
        bodies = eng.stats()["decode_device_steps"] - before
        seen = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "paged_decode" in e.key)
        if best is None or seen > best["profiled"]:
            best = {"profiled": seen, "decode_bodies": bodies, "expected": L * bodies}
        while eng.has_work():
            eng.step()
    check(best["profiled"] == best["expected"] > 0,
          f"horizon 8: the profiler saw {best['profiled']} paged_decode kernels in the "
          f"replays, not {L} x {best['decode_bodies']}")
    return best


class KnownContinuation:
    """A proposer that knows each request's greedy stream and proposes its
    next ``k`` tokens with the last one made wrong: every verify round
    accepts k - 1 drafts, rejects one, emits the bonus token and rolls
    back the rejected draft's page when it opened one."""

    def __init__(self, prompts, streams, vocab):
        self.full = [(p, p + s) for p, s in zip(prompts, streams)]
        self.vocab = vocab

    def propose(self, tokens, k):
        n = len(tokens)
        full = next(f for p, f in self.full if tokens[:len(p)] == p)
        cont = full[n:n + k]
        if cont:
            cont[-1] = (cont[-1] + 1) % self.vocab
        return cont


def decode_parity_phase():
    """llama-1b at full width and depth in fp32: the single-step program,
    the 8-step program, n-gram speculation and a proposer that knows the
    streams (k - 1 of its k drafts right) serve the same greedy streams,
    and the captured decode step gives eager paged_decode's tokens.  fp32,
    so that the verify program's gather attention and kernel B agree to
    summation order."""
    import gc

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048)
    rng = torch.Generator().manual_seed(99)
    lengths = [16, 200] + torch.randint(17, 200, (6,), generator=rng).tolist()
    prompts = pattern_prompts(rng, lengths, model.config.vocab_size)
    runs = {"single_step": {}, "horizon_8": {"decode_horizon": 8},
            "spec_ngram": {"speculative": {"mode": "ngram", "k": 4}},
            "spec_known": {"speculative": {"mode": "ngram", "k": 4}}}
    streams, stats, rec, params = {}, {}, {}, None
    for mode, extra in runs.items():
        proposer = None
        if mode == "spec_known":
            proposer = KnownContinuation(prompts, list(streams["single_step"].values()),
                                         model.config.vocab_size)
        eng = InferenceEngineV2(model, RaggedInferenceConfig.from_dict(dict(
            dtype="fp32", page_size=16, max_seqs=8, max_pages_per_seq=32, num_pages=256,
            **extra)), params=params, seed=0, proposer=proposer)
        params = eng.params
        streams[mode] = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=24)
                                          for p in prompts])
        stats[mode] = eng.decode_stats()
        if mode == "single_step":
            rec["eager_check"] = eager_decode_check(eng, prompts)
        eng.close()
        del eng
        gc.collect()
    del params
    torch.cuda.empty_cache()
    for mode in runs:
        check(streams[mode] == streams["single_step"],
              f"fp32 {mode}: greedy streams differ from the single-step program's")
    known = stats["spec_known"]
    check(known["spec_acceptance_rate"] > 0.5 and known["spec_rollback_pages"] > 0,
          f"fp32 spec_known: acceptance {known['spec_acceptance_rate']}, rollback pages "
          f"{known['spec_rollback_pages']}")
    rec.update(requests=len(prompts), tokens_each=24, streams_identical=True,
               decode_stats={m: {k: stats[m][k] for k in (
                   "decode_tokens_per_host_sync", "decode_tokens_per_invocation",
                   "spec_acceptance_rate", "spec_rollback_pages",
                   "decode_horizon_shrinks")} for m in runs})
    print(json.dumps({"decode_parity": rec}))
    return rec


# -- phase 5: card vs CPU parity ---------------------------------------------

def parity_phase():
    import copy

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_prefill
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    cfg = dict(dtype="fp32", page_size=16, max_seqs=4, max_pages_per_seq=16, num_pages=64)
    rng = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in (7, 40, 100, 23)]
    engines = {dev: InferenceEngineV2(model, RaggedInferenceConfig(**cfg),
                                      params=copy.deepcopy(params), device=dev)
               for dev in ("cuda", "cpu")}
    streams = {dev: e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8)
                                    for p in prompts]) for dev, e in engines.items()}
    check(streams["cuda"] == streams["cpu"],
          f"parity: greedy streams differ: {streams['cuda']} vs {streams['cpu']}")
    # the captured programs (card) against the eager ones (CPU): int8 KV,
    # preemption (16 pages for 4 slots), the multi-step and verify
    # programs, and sampled rows (the device hash, the same on both)
    variants = {"kv_quant": ({"kv_quant": True}, 0.0),
                "preemption": ({"num_pages": 16}, 0.0),
                "horizon_4": ({"decode_horizon": 4}, 0.0),
                "spec_ngram": ({"speculative": {"mode": "ngram", "k": 4}}, 0.0),
                "sampled": ({}, 0.8), "sampled_horizon_4": ({"decode_horizon": 4}, 0.8)}
    rep_prompts = prompts[:3] + [prompts[0] * 6]
    variant_rec = {}
    for name, (extra, temp) in variants.items():
        got, counts = {}, {}
        for dev in ("cuda", "cpu"):
            e = InferenceEngineV2(model, RaggedInferenceConfig.from_dict(dict(cfg, **extra)),
                                  params=engines[dev].params, device=dev, seed=3)
            got[dev] = e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=24,
                                                     temperature=temp) for p in rep_prompts])
            counts[dev] = {**e.decode_stats(), "preemptions": e.stats()["preemptions"]}
            e.assert_no_leaks()
            e.close()
        check(got["cuda"] == got["cpu"],
              f"parity {name}: streams differ card vs CPU: {got['cuda']} vs {got['cpu']}")
        check(counts["cuda"] == counts["cpu"], f"parity {name}: counters {counts}")
        if name == "preemption":
            check(counts["cuda"]["preemptions"] > 0, "parity preemption: nothing preempted")
        variant_rec[name] = {k: counts["cuda"][k] for k in (
            "preemptions", "decode_host_syncs", "spec_accepted_tokens", "spec_verify_calls")}
    # prefill logits of the 100-token prompt through the same program
    ids = torch.zeros(128, dtype=torch.long)
    ids[:100] = torch.tensor(prompts[2])
    rows = torch.arange(8, dtype=torch.int32)
    logits = {}
    for dev, e in engines.items():
        logits[dev], _ = paged_prefill(e.cfg, e.params, e._pools, ids.to(e.device),
                                       rows.to(e.device), 100)
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    check(err <= PARITY_LOGITS_TOL, f"parity: prefill logits max err {err:.3g}")
    rec = {"streams_identical": True, "requests": len(prompts), "tokens_each": 8,
           "variants_identical": variant_rec,
           "prefill_logits_max_abs_err": err, "logits_max_abs": scale,
           "tol": PARITY_LOGITS_TOL}
    print(json.dumps({"parity": rec}))
    return rec

# -- phase 10: kernel W, the weight-only quantized matmul --------------------

#: llama-7b's weight shapes (K, N): q/k/v/o, gate/up, down, the LM head
WQ_SHAPES = {"attn_4096x4096": (4096, 4096), "mlp_up_4096x11008": (4096, 11008),
             "mlp_down_11008x4096": (11008, 4096), "lm_head_4096x32000": (4096, 32000)}


def int4pack_library(codes, scale, x, group):
    """``torch._weight_int4pack_mm`` on the same int4 codes (the one PyTorch
    call computing W's int4 product), repacked here, outside any timing, by
    ``torch._convert_weight_to_int4pack``: its layout is [N, K/2] with the
    even K row in the high nibble, and it dequantizes (code - 8) * scale +
    zero, so zero points of 0 and the scales in bf16 (its scale type) give
    W's function up to the scales' rounding.  A yardstick: the port never
    calls it."""
    vals = torch.stack([codes & 0xF, codes >> 4], dim=1).reshape(-1, codes.shape[1])
    vt = vals.t().contiguous()  # [N, Kp], each the code + 8
    packed = ((vt[:, ::2] << 4) | vt[:, 1::2]).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, w, group, sz)


def wq_case(wq, name, M, K, N, bits, dtype, group=128, timed=False, seed=0):
    """Kernel W against its plain version computed in fp32 on the same x,
    codes and scales (a seeded normal weight, std 0.02, quantized)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    codes, scale = wq.quantize_weight(torch.randn((K, N), generator=g, device=DEV) * 0.02,
                                      bits, group)
    x = torch.randn((M, K), generator=g, device=DEV).to(dtype)
    kw = dict(bits=bits, group=group)
    out = wq.wq_matmul(x, codes, scale, **kw)
    again = wq.wq_matmul(x, codes, scale, **kw)
    ref = wq.wq_matmul_plain(x.float(), codes, scale, **kw)
    torch.cuda.synchronize()
    tol = WQ_TOL[dtype]
    err, atol_used, ok = max_err(out, ref, tol)
    tile = wq._tile(M, dtype, group, wq._tma_ok(x, codes, K, N))
    rec = {"case": name, "shape": [M, K, N], "bits": bits, "group": group,
           "dtype": str(dtype)[6:], "max_abs_err": err, "atol_used": atol_used,
           "ref_max_abs": ref.abs().max().item(), "tol": tol, "kernel": tile.kernel,
           "tile": [tile.rows, tile.cols], "bit_equal_across_calls": torch.equal(out, again)}
    print(json.dumps({"wq_check": rec}))
    check(bool(torch.isfinite(out).all()), f"wq {name}: non-finite output")
    check(ok, f"wq {name}: kernel vs fp32 plain beyond {tol} (max abs {err:.3g}, "
          f"atol used {atol_used:.3g})")
    check(rec["bit_equal_across_calls"], f"wq {name}: outputs differ between two calls")
    if timed:
        item = x.element_size()
        nbytes = codes.numel() + scale.numel() * 4 + x.numel() * item + M * N * item
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N, dtype)
        wd = wq.dequantize_weight(codes, scale, k=K, dtype=dtype, **kw)
        library_ms = None
        if bits == 4 and dtype == torch.bfloat16 and codes.shape[0] * 2 == K:
            try:
                lib = int4pack_library(codes, scale, x, group)
                lib_out = lib()
                torch.cuda.synchronize()
                rec["library_max_abs_err"] = (lib_out.float() - ref).abs().max().item()
                library_ms = device_ms(lib)
            except (RuntimeError, NotImplementedError, TypeError) as e:
                rec["library_error"] = f"{type(e).__name__}: {str(e)[:300]}"
        else:
            rec["library_note"] = ("no single PyTorch call: _weight_int8pack_mm scales per "
                                   "channel, not per group" if bits == 8 else "not timed")
        def new():
            return wq.wq_matmul(x, codes, scale, **kw)

        if BASE is not None:
            # the parent's build on the same inputs: its bits, and its time
            # in turns
            def prev():
                return BASE.swapped("wq_matmul", new)

            same = torch.equal(prev(), out)
            check(same, f"wq {name}: other bits than the parent's build")
            rec["previous_ms"], ms, rec["turns_prev_new_new_prev"] = turns(prev, new)
            rec["bit_equal_to_previous"] = same
        else:
            ms = device_ms(new)
        rec.update(ms=ms, bound_share=b_ms / ms,
                   plain_ms=device_ms(lambda: wq.wq_matmul_plain(x, codes, scale, **kw),
                                      iters=5, warmup=2),
                   library_ms=library_ms,
                   context_cublas_dequantized_ms=device_ms(lambda: x @ wd),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=2.0 * M * K * N)
        del wd
    print(json.dumps({"wq": rec}))
    return rec


def wq_phase(wq):
    """Kernel W at llama-7b's shapes, decode and prefill, int8 and int4
    (timed, bf16 x, bit-equal to the parent's build and in turns with it),
    the token tiles of every M class, fp16 and fp32 x, groups 64, 16 and 48,
    and padded or unaligned corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    recs = []
    for bits in (8, 4):
        for name, (K, N) in WQ_SHAPES.items():
            for M in (8, 900):
                recs.append(wq_case(wq, f"{name}_m{M}_int{bits}", M, K, N, bits, bf16,
                                    timed=True))
        # one slot, the 16- and 32-token tiles' edges, two warpgroups at 64
        for M in (1, 16, 17, 64):
            recs.append(wq_case(wq, f"mlp_up_m{M}_int{bits}", M, 4096, 11008, bits, bf16))
        for dt in (fp16, fp32):
            for M in (8, 900):
                recs.append(wq_case(wq, f"attn_m{M}_int{bits}_{str(dt)[6:]}", M, 4096, 4096,
                                    bits, dt))
        recs.append(wq_case(wq, f"attn_m8_g64_int{bits}", 8, 4096, 4096, bits, bf16, group=64))
        recs.append(wq_case(wq, f"m900_g64_int{bits}_fp16", 900, 4096, 1024, bits, fp16,
                            group=64))
        recs.append(wq_case(wq, f"padded_k4000_int{bits}", 900, 4000, 384, bits, bf16))
        # K and N that TMA cannot read: the FMA kernel
        recs.append(wq_case(wq, f"odd_k1003_n200_g64_int{bits}", 8, 1003, 200, bits, bf16,
                            group=64))
        recs.append(wq_case(wq, f"odd_k1003_n200_g64_int{bits}_fp32", 900, 1003, 200, bits,
                            fp32, group=64))
    # groups off the tensor-core kernel's stage (the reference takes any group
    # dividing the padded K): 16 for int8, 48 for int4
    recs += [
        wq_case(wq, "attn_m8_g16_int8", 8, 4096, 4096, 8, bf16, group=16, timed=True),
        wq_case(wq, "attn_m900_g16_int8_fp16", 900, 4096, 1024, 8, fp16, group=16),
        wq_case(wq, "attn_m8_g48_int4", 8, 4096, 4096, 4, bf16, group=48, timed=True),
        wq_case(wq, "m900_k4000_g48_int4", 900, 4000, 1000, 4, bf16, group=48),
        wq_case(wq, "odd_k1003_g48_int4_fp32", 37, 1003, 200, 4, fp32, group=48),
    ]
    return recs


# -- phase 11: kernels Q and DQ, int8 block quantize / dequantize ------------

def quant_case(qz, name, n, dtype, zero_row=None, timed=False, seed=0):
    """Kernels Q and DQ against their plain versions, bit for bit (DQ on the
    kernel's own codes and scales)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = (torch.randn((n,), generator=g, device=DEV) * 3.0).to(dtype)
    if zero_row is not None:
        x[zero_row * 128:(zero_row + 1) * 128] = 0
    q, s, length = qz.quantize_int8(x)
    q_ref, s_ref, _ = qz.quantize_int8_plain(x)
    y = qz.dequantize_int8(q, s, length, dtype)
    y_ref = qz.dequantize_int8_plain(q, s, length, dtype)
    torch.cuda.synchronize()
    rec = {"case": name, "n": n, "rows": q.shape[0], "dtype": str(dtype)[6:],
           "codes_equal": torch.equal(q, q_ref), "scales_equal": torch.equal(s, s_ref),
           "dequant_equal": torch.equal(y, y_ref),
           "max_abs_err": max((q.int() - q_ref.int()).abs().max().item(),
                              (s - s_ref).abs().max().item(),
                              (y.float() - y_ref.float()).abs().max().item())}
    print(json.dumps({"quant_check": rec}))
    check(rec["codes_equal"] and rec["scales_equal"],
          f"quantize_int8 {name}: codes/scales differ from the plain version")
    check(rec["dequant_equal"], f"dequantize_int8 {name}: differs from the plain version")
    if zero_row is not None:
        floor = torch.tensor(1e-12) * torch.tensor(1.0 / 127.0)
        check(s[zero_row, 0].item() == floor.item() and not q[zero_row].any(),
              f"quantize_int8 {name}: the all-zero row missed the 1e-12 scale floor")
    if timed:
        item = x.element_size()
        rows = q.shape[0]
        q_bytes = n * item + q.numel() + rows * 4
        dq_bytes = q.numel() + rows * 4 + n * item
        qb, qby = bound(q_bytes, 4.0 * n, torch.float32)
        dqb, dqby = bound(dq_bytes, 1.0 * n, torch.float32)
        rec.update(
            quant_ms=device_ms(lambda: qz.quantize_int8(x)),
            quant_plain_ms=device_ms(lambda: qz.quantize_int8_plain(x), iters=5, warmup=2),
            quant_bound_ms=qb, quant_bound_by=qby, quant_bytes=q_bytes,
            dequant_ms=device_ms(lambda: qz.dequantize_int8(q, s, length, dtype)),
            dequant_plain_ms=device_ms(lambda: qz.dequantize_int8_plain(q, s, length, dtype),
                                       iters=5, warmup=2),
            dequant_bound_ms=dqb, dequant_bound_by=dqby, dequant_bytes=dq_bytes)
    print(json.dumps({"quant": rec}))
    return rec


def quant_phase(qz):
    """Kernels Q and DQ on llama-1b's embedding (timed) and odd corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    odd = 128 * 300 + 17  # not a multiple of 128; more rows than block_rows (256)
    return [
        quant_case(qz, "embed_tok_65.5M_bf16", 32000 * 2048, bf16, timed=True),
        quant_case(qz, "embed_tok_65.5M_fp32", 32000 * 2048, fp32),
        quant_case(qz, "odd_38417_fp32_zero_row", odd, fp32, zero_row=5),
        quant_case(qz, "odd_38417_bf16_zero_row", odd, bf16, zero_row=299),
        quant_case(qz, "odd_38417_fp16_zero_row", odd, fp16, zero_row=0),
        quant_case(qz, "three_fp32", 3, fp32),
    ]


# -- phase 12: quantized serving of llama-7b --------------------------------

PROBE_N, PROBE_BUCKET = 300, 512  # the logits probe: one prompt in a 512 bucket


def prefill_probe(cfg, params, ids, dtype):
    """Last-token logits (fp64) of the probe prompt through paged_prefill on
    a KV pool of its own."""
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_prefill
    from deepspeed_tpu_torch.inference.v2.ragged import KVBlockConfig, PagedKVCache

    pages = PROBE_BUCKET // 16
    block = KVBlockConfig(page_size=16, num_pages=pages, max_seqs=1, max_pages_per_seq=pages)
    pools = PagedKVCache.init(cfg.n_layers, cfg.kv_heads, cfg.head_dim, block, dtype,
                              device=DEV)
    rows = torch.arange(pages, dtype=torch.int32, device=DEV)
    return paged_prefill(cfg, params, pools, ids, rows, PROBE_N)[0].double()


def cosine(a, b) -> float:
    return F.cosine_similarity(a, b, dim=0).item()


def dequantized(qparams, like, bits, group):
    """``qparams`` with every ``{"wq", "scale"}`` sub-tree dequantized in
    full to the dtype of the matching leaf of ``like`` (its float tree)."""
    from deepspeed_tpu_torch.models.transformer import ParamTree
    from deepspeed_tpu_torch.ops.wq_matmul import dequantize_weight

    def walk(q, f):
        out = {}
        for n, p in f._parameters.items():
            sub = q._modules.get(n)
            out[n] = (q._parameters[n].detach() if sub is None else dequantize_weight(
                sub.wq, sub.scale, bits=bits, group=group, k=p.shape[0], dtype=p.dtype))
        for n, child in f._modules.items():
            out[n] = ([walk(qc, fc) for qc, fc in zip(q._modules[n], child)]
                      if isinstance(child, torch.nn.ModuleList) else walk(q._modules[n], child))
        return out

    return ParamTree(walk(qparams, like))


def quant_cosine_probe(model, ids):
    """``model`` (2 layers of llama-7b's width) through the bf16 and the
    quant_bits 8 and 4 engines: cosine against the bf16 engine (int8 held
    to ``WQ_COSINE``) and against the bf16 model on the dequantized weights
    (held to ``WQ_DEQUANT_COSINE``)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceConfig

    base = dict(dtype="bf16", page_size=16, max_seqs=1, max_pages_per_seq=32, num_pages=32)
    eng = InferenceEngineV2(model, RaggedInferenceConfig(**base), seed=5)
    ref = prefill_probe(eng.cfg, eng.params, ids, torch.bfloat16)
    out = {}
    for bits in (8, 4):
        q = InferenceEngineV2(model, RaggedInferenceConfig(**base, quant_bits=bits),
                              params=eng.params)
        logits = prefill_probe(q.cfg, q.params, ids, torch.bfloat16)
        ref_dq = prefill_probe(model.config, dequantized(q.params, eng.params, bits,
                                                         q.cfg.wq_group), ids, torch.bfloat16)
        rec = out[f"int{bits}"] = {"vs_bf16": cosine(logits, ref),
                                   "vs_dequantized_bf16": cosine(logits, ref_dq)}
        where = f"int{bits} at {model.config.n_layers} layers"
        check(rec["vs_dequantized_bf16"] > WQ_DEQUANT_COSINE,
              f"{where}: prefill logits cosine {rec['vs_dequantized_bf16']:.5f} vs the "
              f"dequantized weights <= {WQ_DEQUANT_COSINE}")
        check(bits not in WQ_COSINE or rec["vs_bf16"] > WQ_COSINE[bits],
              f"{where}: prefill logits cosine {rec['vs_bf16']:.5f} vs bf16 <= "
              f"{WQ_COSINE.get(bits)}")
    print(json.dumps({"quant_cosine_2_layers": out}))
    return out


def quant_engine_phase(fa, pa, wq):
    """llama-7b at full width and depth through InferenceEngineV2 with
    quant_bits 8 and 4 over the same seeded bf16 weights; the bf16 engine
    and an fp32 copy of its weights give the reference logits."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("7b", max_seq_len=2048, dtype=torch.bfloat16)
    L = model.config.n_layers
    per_call = 7 * L + 1
    rng = torch.Generator().manual_seed(1234)
    lengths = [16, 900] + torch.randint(17, 900, (10,), generator=rng).tolist()
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in lengths]
    base = dict(dtype="bf16", page_size=16, max_seqs=8, max_pages_per_seq=64, num_pages=576)
    ids = torch.zeros(PROBE_BUCKET, dtype=torch.long)
    ids[:PROBE_N] = torch.tensor(prompts[1][:PROBE_N])
    ids = ids.to(DEV)
    results = {"cosine_2_layers": quant_cosine_probe(
        llama_model("7b", max_seq_len=2048, n_layers=2, dtype=torch.bfloat16), ids)}
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngineV2(model, RaggedInferenceConfig(**base), seed=0)
    results["bf16"] = {"init_s": time.perf_counter() - t0, "param_bytes": eng.param_bytes}
    params = eng.params
    eng.close()
    del eng
    ref = prefill_probe(model.config, params, ids, torch.bfloat16)
    params32 = params.map(lambda t: t.float())
    ref32 = prefill_probe(model.config, params32, ids, torch.float32)
    del params32
    results["bf16"].update(cosine_vs_fp32=cosine(ref, ref32),
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.empty_cache()
    for bits in (8, 4):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngineV2(model, RaggedInferenceConfig(**base, quant_bits=bits,
                                                             quant_group=128),
                                params=params, seed=0)
        init_s = time.perf_counter() - t0
        leaf = eng.params.layers[0].attn.wq
        check(eng.cfg.wq_bits == bits and model.config.wq_bits == 0,
              f"int{bits}: wq_bits not on the engine's own config copy")
        code_dtype = torch.int8 if bits == 8 else torch.uint8
        check(leaf.wq.device.type == DEV and leaf.wq.dtype == code_dtype
              and leaf.scale.dtype == torch.float32, f"int{bits}: quantized leaf layout")
        logits = prefill_probe(eng.cfg, eng.params, ids, torch.bfloat16)
        check(bool(torch.isfinite(logits).all()), f"int{bits}: non-finite prefill logits")
        cos, cos32 = cosine(logits, ref), cosine(logits, ref32)
        # warm-up (cuBLAS handles, allocator): one short request, not counted
        eng.generate_all([RaggedRequest(prompt_ids=prompts[0][:32], max_new_tokens=2)])
        rec = drive(eng, [RaggedRequest(prompt_ids=p, max_new_tokens=32) for p in prompts],
                    fa, pa, wq)
        st, la = rec.pop("stats"), rec["launches"]
        calls, steps = st["prefill_calls"], st["decode_model_invocations"]
        check(len(rec["reasons"]) == len(prompts)
              and all(r == "length" for r in rec["reasons"].values())
              and all(len(t) == 32 for t in rec["streams"].values()),
              f"int{bits}: {rec['reasons']}")
        check(calls > 0 and la["wq_matmul"] == per_call * (calls + steps),
              f"int{bits}: wq_matmul launches {la['wq_matmul']} != {per_call} x "
              f"({calls} prefill + {steps} decode calls)")
        check(la["flash"] == L * calls and la["paged"] == L * steps,
              f"int{bits}: flash/paged launches {la} vs {L} x {calls}/{steps}")
        # the captured decode step holds kernels W and B
        names = rec["replay_kernels"] = replay_kernels(eng, "decode")
        check(count_named(names, "wq_") == per_call and count_named(names, "paged_decode") == L,
              f"int{bits}: one decode replay launched {names}, not {per_call} W and {L} B")
        rec["decode_profile"] = profile_steps(
            eng, [RaggedRequest(prompt_ids=p[:64], max_new_tokens=8) for p in prompts[:8]],
            warm_steps=2, steps=4, groups={"wq": "wq_", "paged": "paged_decode"})
        rec.update(stats=st, param_bytes=eng.param_bytes, cosine_vs_bf16=cos,
                   cosine_vs_fp32=cos32, init_s=init_s,
                   wq_per_model_call=per_call,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        rec.pop("streams")
        results[f"int{bits}"] = rec
        print(json.dumps({"quant_engine": f"int{bits}", **{k: v for k, v in rec.items()
                                                          if k != "reasons"}}))
        eng.close()
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


# -- phase 13: init_inference -> generate -> module_quantize -----------------

def inference_v1_phase(qz):
    """llama-1b at full width and depth through the dense-cache engine, then
    module_quantize (kernels Q and DQ, counted) and generate again; then a
    LoRA layer over an int8 base."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.linear.optimized_linear import (LoRAConfig, QuantizationConfig,
                                                             init_lora_linear, lora_linear)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048, dtype=torch.bfloat16)
    V = model.config.vocab_size
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"})
    check(eng.device.type == DEV, f"init_inference engine device is not {DEV}")
    g = torch.Generator(device=DEV).manual_seed(42)
    ids = torch.randint(0, V, (4, 128), generator=g, device=DEV)
    eng.generate(ids[:, :16], max_new_tokens=2)  # warm-up

    def timed_generate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(ids, max_new_tokens=32)
        torch.cuda.synchronize()
        check(out.shape == (4, 160) and torch.equal(out[:, :128], ids)
              and bool(((out >= 0) & (out < V)).all()), f"generate: bad stream {out.shape}")
        return out, time.perf_counter() - t0

    out0, gen_s = timed_generate()
    n_leaves = sum(1 for _, ndim, ts in eng._stacked_leaves()
                   if ndim >= 2 and ts[0].is_floating_point())
    qz.quantize_int8.launches = qz.dequantize_int8.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.module_quantize()
    torch.cuda.synchronize()
    mq_s = time.perf_counter() - t0
    mq = {"quantize_int8": qz.quantize_int8.launches,
          "dequantize_int8": qz.dequantize_int8.launches}
    check(mq["quantize_int8"] == mq["dequantize_int8"] == n_leaves,
          f"module_quantize: launches {mq} != one pair per stacked leaf ({n_leaves})")
    check(all(bool(torch.isfinite(p).all()) for p in eng.params.parameters()),
          "module_quantize: non-finite parameter")
    out1, gen_q_s = timed_generate()

    lora = LoRAConfig(lora_r=16, lora_alpha=32)
    qz.quantize_int8.launches = qz.dequantize_int8.launches = 0
    lp = init_lora_linear(g, 2048, 5504, lora, quantize=QuantizationConfig(),
                          dtype=torch.bfloat16)
    x = torch.randn((512, 2048), generator=g, device=DEV).to(torch.bfloat16)
    y = lora_linear(lp, x, lora)
    lora_l = {"quantize_int8": qz.quantize_int8.launches,
              "dequantize_int8": qz.dequantize_int8.launches}
    check(lora_l == {"quantize_int8": 1, "dequantize_int8": 1},
          f"lora over an int8 base: launches {lora_l}")
    n = 2048 * 5504
    base = qz.dequantize_int8_plain(lp["base_q"], lp["base_scale"], n, torch.bfloat16)
    check(torch.equal(qz.dequantize_int8(lp["base_q"], lp["base_scale"], n, torch.bfloat16),
                      base), "lora_linear: the kernel-dequantized base differs from the plain")
    base = base.reshape(2048, 5504)
    y_ref = x @ base + (x @ lp["lora_a"]) @ lp["lora_b"] * (lora.lora_alpha / lora.lora_r)
    err, _, ok = max_err(y, y_ref, FLASH_TOL[torch.bfloat16])
    check(ok, f"lora_linear: output differs from the plain base's by {err:.3g}")
    rec = {"model": "llama-1b", "batch": [4, 128], "new_tokens": 32, "generate_s": gen_s,
           "decode_tok_per_s": 4 * 32 / gen_s, "module_quantize_s": mq_s,
           "generate_after_quantize_s": gen_q_s, "stacked_leaves_quantized": n_leaves,
           "module_quantize_launches": mq, "lora_launches": lora_l,
           "greedy_tokens_unchanged_share":
               (out1[:, 128:] == out0[:, 128:]).float().mean().item()}
    print(json.dumps({"inference_v1": rec}))
    del eng
    torch.cuda.empty_cache()
    return rec


# -- phase 14: card vs CPU parity of the quantized paths ---------------------

def quant_parity_phase():
    import copy

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    rng = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in (7, 40, 100, 23)]
    rec = {}
    for bits in (8, 4):
        cfg = dict(dtype="fp32", page_size=16, max_seqs=4, max_pages_per_seq=16, num_pages=64,
                   quant_bits=bits, quant_group=128)
        engines = {dev: InferenceEngineV2(model, RaggedInferenceConfig(**cfg),
                                          params=copy.deepcopy(params), device=dev)
                   for dev in ("cuda", "cpu")}
        codes = {dev: e.params.layers[1].mlp.w_down.wq.cpu() for dev, e in engines.items()}
        check(torch.equal(codes["cuda"], codes["cpu"]),
              f"quant parity int{bits}: codes quantized on the card differ from the CPU's")
        streams = {dev: e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8)
                                        for p in prompts]) for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"],
              f"quant parity int{bits}: greedy streams differ: {streams}")
        rec[f"engine_v2_int{bits}"] = {"streams_identical": True, "requests": len(prompts)}
        del engines
    ids = torch.randint(0, model.config.vocab_size, (2, 24), generator=rng)
    engines = {dev: deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"},
                                                       params=copy.deepcopy(params), device=dev)
               for dev in ("cuda", "cpu")}
    for stage in ("generate", "generate_after_module_quantize"):
        if stage != "generate":
            for e in engines.values():
                e.module_quantize()
            diff = max((pc.cpu() - ph).abs().max().item() for pc, ph in zip(
                engines["cuda"].params.parameters(), engines["cpu"].params.parameters()))
            check(diff == 0.0, f"quant parity: module_quantize params differ by {diff}")
        out = {dev: e.generate(ids, max_new_tokens=8).cpu() for dev, e in engines.items()}
        check(torch.equal(out["cuda"], out["cpu"]),
              f"quant parity {stage}: greedy streams differ: {out}")
        rec[f"inference_v1_{stage}"] = {"streams_identical": True, "batch": list(ids.shape)}
    print(json.dumps({"quant_parity": rec}))
    return rec


# -- phase 15: kernel G, the grouped expert matmul ---------------------------

#: Kernel G against its plain version computed in fp32 from the same inputs.
#: rtol is the output's rounding, as above; bf16 and fp16 products are exact
#: in fp32, so atol covers only the fp32 sums taken in another order (K up
#: to 14336, outputs up to |14|): about twice the largest need observed on
#: an H100 (PERF.md): 7.1e-5 bf16, 1.15e-4 fp16, 1.21e-5 fp32.
GMM_TOL = {torch.bfloat16: (1.5e-4, 2.0 ** -8), torch.float16: (2.5e-4, 2.0 ** -11),
           torch.float32: (2.5e-5, 2.0 ** -24)}
MIXTRAL_E, MIXTRAL_H, MIXTRAL_F = 8, 4096, 14336


def routed_block_expert(tokens, E, K, block_rows, seed):
    """The dropless router's padded layout for ``tokens`` random top-``K``
    assignments (``moe/sharded_moe.sort_pad_by_expert``): (dest rows of the
    assignments, n_rows, block_expert)."""
    from deepspeed_tpu_torch.moe.sharded_moe import _top_k, sort_pad_by_expert

    g = torch.Generator(device=DEV).manual_seed(seed)
    idx = _top_k(torch.randn((tokens, E), generator=g, device=DEV), K)
    _, dest, n_rows, be = sort_pad_by_expert(idx.reshape(-1), E, block_rows)
    return dest, n_rows, be


def grouped_mm_offs(be, E, block_rows):
    """The ``offs`` of ``torch._grouped_mm`` for a non-decreasing
    ``block_expert``: the end row of each expert's blocks."""
    return (torch.bincount(be.long(), minlength=E).cumsum(0) * block_rows).to(torch.int32)


def gmm_case(gm, name, P, H, F, block_rows, dtype, E=MIXTRAL_E, routed_tokens=None,
             order=None, timed=False, seed=0):
    """Kernel G against its plain version computed in fp32 on the same x, w
    and block_expert.  ``routed_tokens``: x holds that many tokens' top-2
    assignments in the router's padded layout (zero padding rows, as on the
    main path); else every row is random and ``order`` (or a random draw)
    gives the block -> expert map."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = (torch.randn((E, H, F), generator=g, device=DEV) * 0.02).to(dtype)
    if routed_tokens is not None:
        dest, n_rows, be = routed_block_expert(routed_tokens, E, 2, block_rows, seed + 1)
        check(n_rows == P, f"gmm {name}: router layout has {n_rows} rows, not {P}")
        x = torch.zeros((P, H), device=DEV, dtype=dtype)
        x[dest] = torch.randn((dest.numel(), H), generator=g, device=DEV).to(dtype)
    else:
        x = torch.randn((P, H), generator=g, device=DEV).to(dtype)
        be = (torch.tensor(order, dtype=torch.int32, device=DEV) if order is not None else
              torch.randint(0, E, (P // block_rows,), generator=g, device=DEV,
                            dtype=torch.int32))
    # the main path passes the count of blocks that hold a routed row
    n_used = None
    if routed_tokens is not None:
        n_used = (torch.where(dest < P, dest, -block_rows).max() // block_rows + 1).to(
            torch.int32).reshape(1)
    out = gm.grouped_matmul(x, w, be, block_rows, n_used)
    ref = gm.grouped_matmul_plain(x.float(), w.float(), be, block_rows, n_used)
    torch.cuda.synchronize()
    tol = GMM_TOL[dtype]
    err, atol_used, ok = max_err(out, ref, tol)
    distinct = int(torch.unique(be).numel())
    rec = {"case": name, "shape": [P, H, F], "E": E, "block_rows": block_rows,
           "dtype": str(dtype)[6:], "distinct_experts": distinct,
           "block_expert_head": be[:12].tolist(), "max_abs_err": err, "atol_used": atol_used,
           "ref_max_abs": ref.abs().max().item(), "tol": tol}
    print(json.dumps({"gmm_check": rec}))
    check(bool(torch.isfinite(out).all()), f"gmm {name}: non-finite output")
    check(ok, f"gmm {name}: kernel vs fp32 plain beyond {tol} (max abs {err:.3g}, "
          f"atol used {atol_used:.3g})")
    if dtype != torch.float32:
        again = gm.grouped_matmul(x, w, be, block_rows, n_used)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"gmm {name}: outputs differ between two calls")
        rec["bit_equal_across_calls"] = True
    if n_used is not None:
        rec["n_used"] = int(n_used.item())
        # skipped blocks are the zero padding's own result
        full = gm.grouped_matmul(x, w, be, block_rows)
        torch.cuda.synchronize()
        check(torch.equal(full, out), f"gmm {name}: skipping the padding changed the output")
    if timed:
        item = x.element_size()
        # the work the inputs need: the routed rows (2 per token), each
        # expert's matrix once, the output rows written
        rows = P if routed_tokens is None else 2 * routed_tokens
        nbytes = (rows * H + distinct * H * F + P * F) * item + be.numel() * 4
        ops = 2.0 * rows * H * F
        b_ms, b_by = bound(nbytes, ops, dtype)
        monotone = bool((be[1:] >= be[:-1]).all())
        lib_name = "torch._grouped_mm" if monotone and hasattr(torch, "_grouped_mm") else None
        offs = grouped_mm_offs(be, E, block_rows) if lib_name else None
        def new():
            return gm.grouped_matmul(x, w, be, block_rows, n_used)

        if BASE is not None:
            # the parent's build on the same inputs: its bits, and its time
            # in turns
            def prev():
                return BASE.swapped("grouped_matmul", new)

            same = torch.equal(prev(), out)
            check(same, f"gmm {name}: other bits than the parent's build")
            rec["previous_ms"], ms, rec["turns_prev_new_new_prev"] = turns(prev, new)
            rec["bit_equal_to_previous"] = same
        else:
            ms = device_ms(new)
        rec.update(
            ms=ms, bound_share=b_ms / ms, routed_rows=rows,
            plain_ms=device_ms(lambda: gm.grouped_matmul_plain(x, w, be, block_rows, n_used),
                               iters=5, warmup=2),
            library=lib_name,
            library_ms=(device_ms(lambda: torch._grouped_mm(x, w, offs=offs))
                        if lib_name else None),
            context_cublas_dense_ms=device_ms(lambda: x @ w[0]),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=ops)
    print(json.dumps({"gmm": rec}))
    return rec


def gmm_phase(gm):
    """Kernel G at Mixtral-8x7b's main-path shapes (timed: the decode and
    prefill layouts of the router, gate/up and down) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    H, F = MIXTRAL_H, MIXTRAL_F
    recs = []
    for P, tokens in ((1152, 8), (3072, 1024)):
        for nm, (k, n) in (("up", (H, F)), ("down", (F, H))):
            recs.append(gmm_case(gm, f"{'decode' if P == 1152 else 'prefill'}_{nm}_p{P}",
                                 P, k, n, 128, bf16, routed_tokens=tokens, timed=True))
    recs += [
        gmm_case(gm, "decode_up_p1152_fp16", 1152, H, F, 128, fp16, routed_tokens=8),
        gmm_case(gm, "prefill_down_p3072_fp16", 3072, F, H, 128, fp16, routed_tokens=1024),
        gmm_case(gm, "decode_up_p1152_fp32", 1152, H, F, 128, fp32, routed_tokens=8),
        gmm_case(gm, "prefill_up_p3072_fp32", 3072, H, F, 128, fp32, routed_tokens=1024),
        gmm_case(gm, "nonmonotone_br8_bf16", 40, 32, 48, 8, bf16, E=3,
                 order=[0, 2, 1, 1, 0]),
        gmm_case(gm, "nonmonotone_br16_p1152_bf16", 1152, H, 1024, 16, bf16),
        gmm_case(gm, "nonmonotone_br16_fp32", 1152, 1024, 512, 16, fp32),
        gmm_case(gm, "ragged_f100_bf16", 1152, H, 100, 128, bf16),
        gmm_case(gm, "ragged_f100_fp32", 1152, H, 100, 128, fp32),
        gmm_case(gm, "ragged_h1003_f200_br16_fp16", 256, 1003, 200, 16, fp16),
        gmm_case(gm, "one_expert_all_blocks_bf16", 1152, H, 2048, 128, bf16,
                 order=[5] * 9),
    ]
    return recs


# -- phase 16: Mixtral-8x7b serving ------------------------------------------

MIXTRAL_LAYERS = 16  # of 32: 16 layers of bf16 weights fill 47 GB of the 80 GB card


def mixtral_engine_phase(fa, pa, gmm):
    """Mixtral-8x7b at full width and 16 layers, bf16, dropless
    (``moe_drop_tokens=False``), seeded random weights, through
    ``InferenceEngineV2`` (whole-prompt and 256-token chunked prefill, the 12
    requests of phase 4) and ``init_inference`` -> ``generate`` on the same
    tree.  Counters zeroed before and read after each drive: exactly
    3 x layers G launches per prefill, chunk and decode call, flash and paged
    on every layer."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.models.transformer import param_count

    model = mixtral_model("8x7b", max_seq_len=2048, n_layers=MIXTRAL_LAYERS,
                          dtype=torch.bfloat16, moe_drop_tokens=False)
    L = model.config.n_layers
    per_call = 3 * L
    rng = torch.Generator().manual_seed(1234)
    lengths = [16, 900] + torch.randint(17, 900, (10,), generator=rng).tolist()
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in lengths]
    torch.cuda.reset_peak_memory_stats()
    results, params = {"params": param_count(model.config)}, None
    for mode, chunk in (("whole_prompt", 0), ("chunked_256", 256)):
        cfg = RaggedInferenceConfig(dtype="bf16", page_size=16, max_seqs=8,
                                    max_pages_per_seq=64, num_pages=576, prefill_chunk=chunk)
        t0 = time.perf_counter()
        eng = InferenceEngineV2(model, cfg, params=params, seed=0)
        init_s = time.perf_counter() - t0
        params = eng.params
        check(eng.device.type == "cuda" and all(
            p.is_cuda and p.dtype == torch.bfloat16 for p in eng.params.parameters()),
            "mixtral: params are not bf16 on cuda")
        eng.generate_all([RaggedRequest(prompt_ids=prompts[0][:32], max_new_tokens=2)])
        rec = drive(eng, [RaggedRequest(prompt_ids=p, max_new_tokens=32) for p in prompts],
                    fa, pa, gmm=gmm)
        st, la = rec["stats"], rec["launches"]
        calls = st["prefill_calls"] + st["prefill_chunk_calls"]
        steps = st["decode_model_invocations"]
        check(len(rec["reasons"]) == len(prompts)
              and all(r == "length" for r in rec["reasons"].values())
              and all(len(t) == 32 for t in rec["streams"].values()),
              f"mixtral {mode}: {rec['reasons']}")
        check(calls > 0 and steps > 0 and la["grouped_matmul"] == per_call * (calls + steps),
              f"mixtral {mode}: grouped_matmul launches {la['grouped_matmul']} != {per_call} x "
              f"({calls} prefill + {steps} decode calls)")
        check(la["flash"] == L * calls and la["paged"] == L * steps,
              f"mixtral {mode}: flash/paged launches {la} vs {L} x {calls}/{steps}")
        # the captured decode step holds kernels G and B
        names = rec["replay_kernels"] = replay_kernels(eng, "decode")
        check(count_named(names, "gmm_") == per_call
              and count_named(names, "paged_decode") == L,
              f"mixtral {mode}: one decode replay launched {names}, not {per_call} G and {L} B")
        if not chunk:
            rec["decode_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=p[:64], max_new_tokens=8) for p in prompts[:8]],
                warm_steps=2, steps=4, groups={"paged": "paged_decode"})
            rec["prefill_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=prompts[1], max_new_tokens=1)],
                warm_steps=0, steps=1)
        rec.update(init_s=init_s, param_bytes=eng.param_bytes, gmm_per_model_call=per_call,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        rec.pop("streams")
        results[mode] = rec
        print(json.dumps({"mixtral_engine": mode, **{k: v for k, v in rec.items()
                                                     if k != "reasons"}}))
        eng.close()
        del eng

    # the dense-cache engine on the same tree: B = 4 prompts of 128 tokens
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"}, params=params)
    g = torch.Generator(device=DEV).manual_seed(42)
    ids = torch.randint(0, model.config.vocab_size, (4, 128), generator=g, device=DEV)
    eng.generate(ids[:, :16], max_new_tokens=2)  # warm-up
    gmm.grouped_matmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = gmm.grouped_matmul.launches
    check(out.shape == (4, 144) and torch.equal(out[:, :128], ids)
          and bool(((out >= 0) & (out < model.config.vocab_size)).all()),
          f"mixtral generate: bad stream {tuple(out.shape)}")
    check(launches == per_call * 16,
          f"mixtral generate: grouped_matmul launches {launches} != {per_call} x 16 calls")
    results["generate"] = {"batch": [4, 128], "new_tokens": 16, "generate_s": gen_s,
                           "decode_tok_per_s": 4 * 16 / gen_s,
                           "launches": {"grouped_matmul": launches}}
    results["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps({"mixtral_generate": results["generate"],
                      "peak_mem_gb": results["peak_mem_gb"]}))
    del eng, params
    torch.cuda.empty_cache()
    return results


# -- phase 17: card vs CPU parity of the MoE paths ---------------------------

def record_routing():
    """Patch the router so every call appends its top-k expert indices to
    the returned list (restore with the returned function)."""
    from deepspeed_tpu_torch.moe import sharded_moe

    seen, orig = [], sharded_moe._gate_and_aux

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[1].cpu())
        return out

    sharded_moe._gate_and_aux = wrapped
    return seen, lambda: setattr(sharded_moe, "_gate_and_aux", orig)


def moe_parity_phase():
    """A 1-layer Mixtral-8x7b-width model in fp32 on the card and on the CPU
    from the same weights, dropless and capacity: prefill logits within
    ``PARITY_LOGITS_TOL`` with identical router top-2 choices, and identical
    greedy streams from ``InferenceEngineV2`` and ``init_inference``."""
    import copy

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_prefill
    from deepspeed_tpu_torch.models.mixtral import mixtral_model

    t_start = time.perf_counter()
    base = mixtral_model("8x7b", max_seq_len=2048, n_layers=1)
    params = base.init_params(torch.Generator(device=DEV).manual_seed(7), DEV).map(
        lambda t: t.cpu())
    torch.cuda.empty_cache()
    rng = torch.Generator().manual_seed(10)
    prompts = [torch.randint(0, base.config.vocab_size, (n,), generator=rng).tolist()
               for n in (9, 40)]
    cfg = dict(dtype="fp32", page_size=16, max_seqs=2, max_pages_per_seq=8, num_pages=16)
    ids = torch.zeros(64, dtype=torch.long)
    ids[:40] = torch.tensor(prompts[1])
    rows = torch.arange(4, dtype=torch.int32)
    dense_ids = torch.randint(0, base.config.vocab_size, (2, 12), generator=rng)
    out = {}
    for drop in (False, True):
        model = mixtral_model("8x7b", max_seq_len=2048, n_layers=1, moe_drop_tokens=drop)
        engines = {dev: InferenceEngineV2(model, RaggedInferenceConfig(**cfg),
                                          params=copy.deepcopy(params), device=dev)
                   for dev in ("cuda", "cpu")}
        streams = {dev: e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=4)
                                        for p in prompts]) for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"],
              f"moe parity drop={drop}: greedy streams differ: {streams}")
        logits, routes = {}, {}
        for dev, e in engines.items():
            seen, restore = record_routing()
            try:
                logits[dev], _ = paged_prefill(e.cfg, e.params, e._pools, ids.to(e.device),
                                               rows.to(e.device), 40)
            finally:
                restore()
            routes[dev] = seen
        err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
        check(err <= PARITY_LOGITS_TOL, f"moe parity drop={drop}: prefill logits max err "
              f"{err:.3g}")
        check(len(routes["cuda"]) == len(routes["cpu"]) == 1
              and torch.equal(routes["cuda"][0], routes["cpu"][0]),
              f"moe parity drop={drop}: router top-2 choices differ")
        del engines
        dense = {dev: deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "fp32"}, params=copy.deepcopy(params), device=dev)
            for dev in ("cuda", "cpu")}
        gen = {dev: e.generate(dense_ids, max_new_tokens=4).cpu() for dev, e in dense.items()}
        check(torch.equal(gen["cuda"], gen["cpu"]),
              f"moe parity drop={drop}: init_inference greedy streams differ: {gen}")
        del dense
        torch.cuda.empty_cache()
        out[f"drop_tokens_{drop}"] = {
            "streams_identical": True, "router_choices_identical": True,
            "generate_identical": True, "prefill_logits_max_abs_err": err,
            "logits_max_abs": logits["cpu"].abs().max().item(), "tol": PARITY_LOGITS_TOL}
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"moe_parity": out}))
    return out


# -- phase 21: kernels G' and G'', the grouped matmul's backward -------------

#: Mixtral-8x7b's training layout: 4096 tokens (seq 1024 x micro-batch 4)
#: at top-2 in the router's padded layout, P = (8192 / 128 + 8) x 128 rows
MIXTRAL_TRAIN_TOKENS = 4096
#: Mixtral 8x160m's widths (deepspeed_tpu/models/mixtral.py:20): hidden, ffn
MIXTRAL_8X160M_H, MIXTRAL_8X160M_F = 768, 2048


def _gmm_bwd_inputs(name, P, H, F, block_rows, dtype, E, routed_tokens, order, n_used_blocks,
                    seed):
    """(x [P, H], w [E, H, F], dy [P, F], block_expert, n_used) of one G'/G''
    case.  ``routed_tokens``: the router's layout, x and dy random on the
    routed rows and zero on the padding (as on the main path), n_used the
    router's; else every row random, ``order`` (or a random draw) the
    block -> expert map and ``n_used_blocks`` the count of used blocks."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = (torch.randn((E, H, F), generator=g, device=DEV) * 0.02).to(dtype)
    n_used = None
    if routed_tokens is not None:
        dest, n_rows, be = routed_block_expert(routed_tokens, E, 2, block_rows, seed + 1)
        check(n_rows == P, f"gmm bwd {name}: router layout has {n_rows} rows, not {P}")
        x = torch.zeros((P, H), device=DEV, dtype=dtype)
        dy = torch.zeros((P, F), device=DEV, dtype=dtype)
        x[dest] = torch.randn((dest.numel(), H), generator=g, device=DEV).to(dtype)
        dy[dest] = (torch.randn((dest.numel(), F), generator=g, device=DEV) * 0.1).to(dtype)
        n_used = (torch.where(dest < P, dest, -block_rows).max() // block_rows + 1).to(
            torch.int32).reshape(1)
    else:
        x = torch.randn((P, H), generator=g, device=DEV).to(dtype)
        dy = (torch.randn((P, F), generator=g, device=DEV) * 0.1).to(dtype)
        be = (torch.tensor(order, dtype=torch.int32, device=DEV) if order is not None else
              torch.randint(0, E, (P // block_rows,), generator=g, device=DEV,
                            dtype=torch.int32))
        if n_used_blocks is not None:
            n_used = torch.tensor([n_used_blocks], dtype=torch.int32, device=DEV)
    return x, w, dy, be, n_used


def gmm_bwd_case(gm, name, P, H, F, block_rows, dtype, E=MIXTRAL_E, routed_tokens=None,
                 order=None, n_used_blocks=None, timed=False, rounds=5, seed=0):
    """Kernels G' (dx = dy w[e]^T) and G'' (dw[e] = sum of x_b^T dy_b)
    against their plain versions computed in fp32 on the same inputs
    (``GMM_TOL``), each bit-equal across two calls and to the parent's
    build, G' where the parent split no K (its K-split kernel added fp32
    partials in split order; G' splits none); with the router's
    ``n_used``, the same bits as without it (the padding is zeros).
    ``timed``: each beside its bound, its plain version and
    ``torch._grouped_mm``, and in ``rounds`` rounds of turns with the
    parent's build."""
    x, w, dy, be, n_used = _gmm_bwd_inputs(name, P, H, F, block_rows, dtype, E, routed_tokens,
                                           order, n_used_blocks, seed)

    def new_dx():
        return gm.grouped_matmul_dx(dy, w, be, block_rows, n_used)

    def new_dw():
        return gm.grouped_matmul_dw(x, dy, be, E, block_rows, n_used)

    dx, dw = new_dx(), new_dw()
    dx_ref = gm.grouped_matmul_dx_plain(dy.float(), w.float(), be, block_rows, n_used)
    dw_ref = gm.grouped_matmul_dw_plain(x.float(), dy.float(), be, E, block_rows, n_used)
    torch.cuda.synchronize()
    tol = GMM_TOL[dtype]
    rec = {"case": name, "shape": [P, H, F], "E": E, "block_rows": block_rows,
           "dtype": str(dtype)[6:], "tol": tol,
           "experts_with_rows": int(torch.unique(
               be if n_used is None else be[:int(n_used.item())]).numel())}
    for what, out, ref in (("dx", dx, dx_ref), ("dw", dw, dw_ref)):
        err, atol_used, ok = max_err(out, ref, tol)
        rec.update({f"{what}_max_abs_err": err, f"{what}_atol_used": atol_used,
                    f"{what}_ref_max_abs": ref.abs().max().item()})
        check(bool(torch.isfinite(out).all()), f"gmm bwd {name}: non-finite {what}")
        check(ok, f"gmm bwd {name}: {what} kernel vs fp32 plain beyond {tol} (max abs "
              f"{err:.3g}, atol used {atol_used:.3g})")
    rec["max_abs_err"] = max(rec["dx_max_abs_err"], rec["dw_max_abs_err"])
    again = (gm.grouped_matmul_dx(dy, w, be, block_rows, n_used),
             gm.grouped_matmul_dw(x, dy, be, E, block_rows, n_used))
    torch.cuda.synchronize()
    check(torch.equal(dx, again[0]) and torch.equal(dw, again[1]),
          f"gmm bwd {name}: outputs differ between two calls")
    rec["bit_equal_across_calls"] = True
    if BASE is not None:  # the parent's build of G' and G'' on the same inputs
        prev = (BASE.swapped("grouped_matmul", new_dx), BASE.swapped("grouped_matmul", new_dw))
        rec["dx_previous_splits"] = BASE.libs["grouped_matmul"].dstpu_grouped_matmul_dx_splits(
            dy.data_ptr(), w.data_ptr(), gm.op_builder.dtype_code(dtype), P, H, F, E,
            block_rows)
        if rec["dx_previous_splits"] > 1:  # other partial sums: G'' alone is compared
            torch.cuda.synchronize()
            rec["dx_bit_equal_to_previous"] = torch.equal(prev[0], dx)
            same_as_previous(rec, f"gmm bwd {name}", prev[1:], (dw,))
        else:
            same_as_previous(rec, f"gmm bwd {name}", prev, (dx, dw))
    live_be = be if n_used is None else be[:int(n_used.item())]
    empty = [e for e in range(E) if not bool((live_be == e).any())]
    if empty:
        check(bool((dw[empty] == 0).all()), f"gmm bwd {name}: an expert with no rows got a "
              f"nonzero dw")
        rec["experts_without_rows"] = empty
    if n_used is not None:
        rec["n_used"] = int(n_used.item())
        if routed_tokens is not None:  # the skipped blocks are the zero padding's own result
            full = (gm.grouped_matmul_dx(dy, w, be, block_rows),
                    gm.grouped_matmul_dw(x, dy, be, E, block_rows))
            torch.cuda.synchronize()
            check(torch.equal(full[0], dx) and torch.equal(full[1], dw),
                  f"gmm bwd {name}: skipping the padding changed the gradients")
        else:
            live = int(n_used.item()) * block_rows
            check(bool((dx[live:] == 0).all()), f"gmm bwd {name}: rows past n_used not zero")
    if timed:
        item = x.element_size()
        rows = P if routed_tokens is None else 2 * routed_tokens
        experts = rec["experts_with_rows"]
        ops = 2.0 * rows * H * F
        # dx: the routed rows of dy, each expert's matrix once, dx written;
        # dw: the routed rows of x and dy, each expert's dw written
        dx_bytes = (rows * F + experts * H * F + P * H) * item + be.numel() * 4
        dw_bytes = (rows * (H + F) + E * H * F) * item + be.numel() * 4
        offs = grouped_mm_offs(be, E, block_rows)
        for what, fn, nbytes, lib in (
                ("dx", new_dx, dx_bytes,
                 lambda: torch._grouped_mm(dy, w.transpose(1, 2), offs=offs)),
                ("dw", new_dw, dw_bytes, lambda: torch._grouped_mm(x.t(), dy, offs=offs))):
            b_ms, b_by = bound(nbytes, ops, dtype)
            if BASE is not None:  # in rounds of turns with the parent's build
                rs = [turns(lambda fn=fn: BASE.swapped("grouped_matmul", fn), fn)
                      for _ in range(rounds)]
                rec[f"{what}_previous_ms"] = sum(r[0] for r in rs) / rounds
                ms = sum(r[1] for r in rs) / rounds
                rec[f"{what}_turns_prev_new_new_prev"] = [r[2] for r in rs]
                rec[f"{what}_speedup_per_round"] = [r[0] / r[1] for r in rs]
            else:
                ms = device_ms(fn)
            rec.update({f"{what}_ms": ms, f"{what}_bound_ms": b_ms, f"{what}_bound_by": b_by,
                        f"{what}_bound_share": b_ms / ms, f"{what}_bytes": nbytes})
            try:  # the yardstick only: the port never calls it
                lib()
                rec[f"{what}_library_ms"] = device_ms(lib)
            except (RuntimeError, AttributeError, TypeError) as e:
                rec[f"{what}_library_ms"] = None
                rec[f"{what}_library_error"] = str(e)[:200]
        rec.update(routed_rows=rows, flops=ops, library="torch._grouped_mm",
                   dx_plain_ms=device_ms(lambda: gm.grouped_matmul_dx_plain(
                       dy, w, be, block_rows, n_used), iters=3, warmup=1),
                   dw_plain_ms=device_ms(lambda: gm.grouped_matmul_dw_plain(
                       x, dy, be, E, block_rows, n_used), iters=3, warmup=1))
    print(json.dumps({"gmm_bwd": rec}))
    return rec


def gmm_bwd_phase(gm):
    """Kernels G' and G'' at Mixtral-8x7b's and Mixtral-8x160m's training
    shapes (4096 tokens at top-2 in the router's layout, P = 9216; gate/up
    and down; timed in bf16), at a small batch's (512 tokens, P = 2048,
    where the parent split G''s K; timed) and the corners: fp16 and fp32,
    block_rows 64 and 16, an expert with no rows in a non-monotone map,
    n_used below the block count with random rows past it and n_used 0,
    ragged H and F, an odd count of 128-row tiles of H (a cluster's second
    block past H in G'', past N in G'), an odd count of 128-column tiles
    of F, an odd run of tiles starting at an odd tile at the last expert,
    more runs than G''s grid has slots (experts alternating), the last two
    with K of 192 and 128 (fewer K steps than G''s ring has stages, so a
    block's second run meets stages its first released)."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    H, F, T = MIXTRAL_H, MIXTRAL_F, MIXTRAL_TRAIN_TOKENS
    P = (-(-2 * T // 128) + MIXTRAL_E) * 128
    t_s = 512  # a small batch: micro-batch 1 at seq 512
    p_s = (-(-2 * t_s // 128) + MIXTRAL_E) * 128
    h_s, f_s = MIXTRAL_8X160M_H, MIXTRAL_8X160M_F
    return [
        gmm_bwd_case(gm, f"train_up_p{P}", P, H, F, 128, bf16, routed_tokens=T, timed=True),
        gmm_bwd_case(gm, f"train_down_p{P}", P, F, H, 128, bf16, routed_tokens=T, timed=True),
        gmm_bwd_case(gm, f"train_8x160m_up_p{P}", P, h_s, f_s, 128, bf16, routed_tokens=T,
                     timed=True),
        gmm_bwd_case(gm, f"train_8x160m_down_p{P}", P, f_s, h_s, 128, bf16, routed_tokens=T,
                     timed=True),
        gmm_bwd_case(gm, f"train_up_p{p_s}", p_s, H, F, 128, bf16, routed_tokens=t_s,
                     timed=True),
        gmm_bwd_case(gm, f"train_8x160m_up_p{p_s}", p_s, h_s, f_s, 128, bf16,
                     routed_tokens=t_s, timed=True),
        gmm_bwd_case(gm, f"train_up_p{P}_fp16", P, H, F, 128, fp16, routed_tokens=T),
        gmm_bwd_case(gm, f"train_down_p{P}_fp32", P, F, H, 128, fp32, routed_tokens=T),
        gmm_bwd_case(gm, "train_up_br64_bf16", (-(-2 * T // 64) + MIXTRAL_E) * 64, H, F, 64,
                     bf16, routed_tokens=T),
        gmm_bwd_case(gm, "train_down_br16_fp16", (-(-2 * T // 16) + MIXTRAL_E) * 16, F, H, 16,
                     fp16, routed_tokens=T),
        gmm_bwd_case(gm, "no_rows_expert3_nonmonotone_bf16", 1152, 1024, 2048, 128, bf16,
                     order=[0, 5, 5, 1, 7, 0, 2, 6, 4]),
        gmm_bwd_case(gm, "no_rows_expert3_br16_fp32", 512, 512, 256, 16, fp32,
                     order=[e for e in (0, 1, 2, 4, 5, 6, 7, 1) for _ in range(4)]),
        gmm_bwd_case(gm, "n_used_5_of_9_bf16", 1152, 1024, 2048, 128, bf16,
                     order=[0, 1, 1, 2, 4, 4, 6, 7, 7], n_used_blocks=5),
        gmm_bwd_case(gm, "n_used_3_of_9_br64_fp16", 576, 512, 1024, 64, fp16,
                     order=[0, 0, 2, 3, 3, 5, 6, 7, 7], n_used_blocks=3),
        gmm_bwd_case(gm, "ragged_f100_bf16", 1152, H, 100, 128, bf16),
        gmm_bwd_case(gm, "ragged_h1003_f200_br16_fp16", 256, 1003, 200, 16, fp16),
        gmm_bwd_case(gm, "ragged_h1003_f200_br16_fp32", 256, 1003, 200, 16, fp32),
        gmm_bwd_case(gm, "h640_odd_row_tiles_bf16", 1152, 640, 2048, 128, bf16, E=4,
                     order=[0, 0, 1, 2, 2, 3, 3, 3, 1]),
        gmm_bwd_case(gm, "f640_odd_col_tiles_fp16", 1152, 1024, 640, 128, fp16,
                     order=[0, 1, 1, 2, 3, 4, 4, 6, 7]),
        gmm_bwd_case(gm, "odd_run_at_last_expert_bf16", 1152, 1024, 1024, 128, bf16, E=4,
                     order=[0, 0, 0, 1, 1, 2, 2, 3, 3]),
        gmm_bwd_case(gm, "n_used_0_bf16", 1152, 1024, 2048, 128, bf16, E=4,
                     order=[0, 1, 1, 2, 2, 3, 3, 3, 3], n_used_blocks=0),
        gmm_bwd_case(gm, "alternating_experts_e2_bf16", 2560, 512, 1024, 128, bf16, E=2,
                     order=[0, 1] * 10),
        gmm_bwd_case(gm, "alternating_experts_e2_k192_bf16", 2560, 512, 192, 128, bf16, E=2,
                     order=[0, 1] * 10),
        gmm_bwd_case(gm, "alternating_experts_e4_h640_k128_bf16", 2560, 640, 128, 128, bf16,
                     E=4, order=[0, 1, 2, 3] * 5),
    ]


# -- phase 22: MoE training ----------------------------------------------------

#: MoE training runs: Mixtral 8x160m (deepspeed_tpu/models/mixtral.py:21) at
#: full width and depth, and Mixtral 8x7b at full width cut to 2 of 32
#: layers (3.16 B parameters, ~63 GB of training state) with activation
#: checkpointing
MOE_TRAIN_8X7B_LAYERS = 2


def zero_moe_counters(fa, fadam, gm):
    zero_train_counters(fa, fadam)
    for c in (gm.grouped_matmul, gm.grouped_matmul_dx, gm.grouped_matmul_dw):
        c.launches = 0


def read_moe_counters(fa, fadam, gm):
    return {**read_train_counters(fa, fadam), "grouped_matmul": gm.grouped_matmul.launches,
            "grouped_matmul_dx": gm.grouped_matmul_dx.launches,
            "grouped_matmul_dw": gm.grouped_matmul_dw.launches}


def moe_train_run(fa, fadam, gm, size, layers, steps, remat, probe=None, batch_seed=123):
    """One Mixtral model through initialize -> train_batch (bf16, dropless,
    the bench's ds-config without its telemetry block, which the port
    raises for until ROADMAP #16): ``steps`` steps on one seeded batch.
    ``probe(engine, batch)`` runs first, outside the counted drive.
    Counters zeroed just before the drive and read just after; every
    launch count is held to what the layers and steps give.  Returns
    (engine, batch, record)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import mixtral_model
    from deepspeed_tpu_torch.models.transformer import flops_per_token

    model = mixtral_model(size, max_seq_len=TRAIN_SEQ, n_layers=layers, moe_drop_tokens=False,
                          remat=remat)
    cfg = model.config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(), seed=0)
    init_s = time.perf_counter() - t0
    n_leaves = len(engine._master)
    g = torch.Generator(device=DEV).manual_seed(batch_seed)
    batch = torch.randint(0, cfg.vocab_size, (1, TRAIN_MICRO, TRAIN_SEQ), generator=g,
                          device=DEV)
    probed = probe(engine, batch) if probe is not None else None
    zero_moe_counters(fa, fadam, gm)
    losses, step_ms, syncs = timed_steps(engine, batch, steps)
    launches = read_moe_counters(fa, fadam, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    name = f"moe train {size} x{layers}{' remat' if remat else ''}"
    check(all(map(math.isfinite, losses)), f"{name}: non-finite loss {losses}")
    fwd = 2 if remat else 1  # the recompute runs each block's forward again
    want = {"flash_fwd": fwd * layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps, "fused_adam": n_leaves * steps,
            "grouped_matmul": 3 * fwd * layers * steps,
            "grouped_matmul_dx": 3 * layers * steps, "grouped_matmul_dw": 3 * layers * steps}
    for k, v in want.items():
        check(launches[k] == v, f"{name}: {k} launches {launches[k]} != {v}")
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = TRAIN_MICRO * TRAIN_SEQ
    fpt = flops_per_token(cfg, TRAIN_SEQ)
    rec = {"model": f"mixtral-{size}", "layers": layers, "remat": remat,
           "params": sum(p.numel() for p in engine._master), "leaves": n_leaves,
           "seq": TRAIN_SEQ, "micro_batch": TRAIN_MICRO, "dtype": "bf16", "init_s": init_s,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / (med / 1e3), "flops_per_token_active": fpt,
           "mfu": fpt * tokens / (med / 1e3) / PEAK_OPS[torch.bfloat16],
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "host_syncs": syncs, "grad_norm": engine.get_global_grad_norm(),
           "telemetry": "left out: the port raises for the bench's telemetry block (#16)"}
    return engine, batch, rec, probed


def moe_train_phase(fa, fadam, gm):
    """Run 1: Mixtral 8x160m at full width and depth, 8 steps (the loss must
    fall, no host sync inside a step), with a profiled step.  Run 2:
    Mixtral 8x7b at full width and ``MOE_TRAIN_8X7B_LAYERS`` layers with
    remat (nothing_saveable), then without, from the same seed and batch:
    the first micro-batch's loss and every leaf's gradient bit-equal, the
    two steps' losses and grad norms bit-equal, and the peak memory of
    each."""
    run1, batch, rec1, _ = moe_train_run(fa, fadam, gm, "8x160m", 12, 8, remat=False)
    check(rec1["losses"][-1] < rec1["losses"][0],
          f"moe train 8x160m: loss did not fall over 8 steps: {rec1['losses']}")
    check(rec1["host_syncs"] == 0, f"moe train 8x160m: {rec1['host_syncs']} host syncs "
          f"inside bf16 train_batch calls")
    rec1["profile"] = profile_window(
        lambda: run1.train_batch(batch), 1, top_n=12,
        groups={"grouped_matmul": "gmm_wgmma_kernel<__nv_bfloat16, false>",
                "grouped_matmul_dx": "gmm_dx_wgmma_kernel",
                "grouped_matmul_dw": "gmm_dw_", "flash": "flash_", "fused_adam": "adam"})
    del run1
    out = {"run1": rec1}
    first = {}

    def grads_of_first_micro(remat):
        def probe(engine, batch):
            grads, loss, _ = engine._micro_grads(batch[0])
            torch.cuda.synchronize()
            if remat:  # kept on the host until the run without remat
                first["loss"], first["grads"] = loss.cpu(), [g.cpu() for g in grads]
                return None
            same = torch.equal(loss.cpu(), first["loss"]) and all(
                torch.equal(g.cpu(), h) for g, h in zip(grads, first["grads"]))
            return same
        return probe

    L = MOE_TRAIN_8X7B_LAYERS
    for remat in (True, False):
        eng, _, rec, same = moe_train_run(fa, fadam, gm, "8x7b", L, 2, remat=remat,
                                          probe=grads_of_first_micro(remat))
        rec["grad_norms_last"] = eng.get_global_grad_norm()
        out[f"run2_remat_{remat}"] = rec
        del eng
        torch.cuda.empty_cache()
    a, b = out["run2_remat_True"], out["run2_remat_False"]
    check(same, "moe train 8x7b: remat changed the first micro-batch's loss or a gradient")
    check(a["losses"] == b["losses"] and a["grad_norm"] == b["grad_norm"],
          f"moe train 8x7b: remat changed the losses {a['losses']} vs {b['losses']}")
    out["run2_bit_equal"] = {"first_grads_leaves": len(first["grads"]), "losses": True,
                             "grad_norm": True, "first_grads": True}
    del first["grads"]
    print(json.dumps({"moe_train": out}))
    return out


# -- phase 18: kernel S, block-sparse attention -------------------------------

#: Kernel S against its plain version computed in fp32 from the same
#: inputs.  It is the flash-forward tile (probabilities rounded to the input
#: type as the PV operand, everything else fp32), so the reasons are
#: FLASH_TOL's: rtol the output's rounding, atol about twice the largest
#: need observed on an H100 in this phase (PERF.md): 2.12e-3 bf16, 2.69e-4
#: fp16 (D = 128), 1.51e-6 fp32 (sums over up to 1,152 keys in another
#: order).
SPARSE_TOL = {torch.bfloat16: (4.5e-3, 2.0 ** -8), torch.float16: (6e-4, 2.0 ** -11),
              torch.float32: (3e-6, 2.0 ** -24)}
#: BERT-large's heads at the long sequence of DeepSpeed's sparse-attention
#: tutorial: B = 1, S = 4096, H = 16, D = 64, layout block 128
SPARSE_SHAPE = (1, 4096, 16, 64)


def sparse_configs(sa, H):
    """The three layouts of the reference's defaults (Fixed 4 local / 1
    global, BSLongformer window 3 / global (0,), BigBird 1 random / window 3
    / 1 global)."""
    return {"fixed": sa.FixedSparsityConfig(num_heads=H, block=128, num_local_blocks=4,
                                            num_global_blocks=1),
            "bslongformer": sa.BSLongformerSparsityConfig(
                num_heads=H, block=128, num_sliding_window_blocks=3, global_block_indices=(0,)),
            "bigbird": sa.BigBirdSparsityConfig(num_heads=H, block=128, num_random_blocks=1,
                                                num_sliding_window_blocks=3,
                                                num_global_blocks=1)}


def empty_row_config(sa, H, row, block=128):
    """A Fixed layout with block row ``row`` of every head off: its queries
    see no key, and their output is 0."""
    class EmptyRow(sa.FixedSparsityConfig):
        def make_layout(self, seq_len):
            lay = super().make_layout(seq_len)
            lay[:, row, :] = False
            return lay
    return EmptyRow(num_heads=H, block=block)


def sparse_pairs(layout, causal, B):
    """Visible block pairs of a ``[H, NB, NB]`` layout, a diagonal block
    counting half under causal."""
    lay = torch.as_tensor(layout).bool()
    if not causal:
        return float(lay.sum().item()) * B
    nb = lay.shape[1]
    below = lay & torch.ones((nb, nb), dtype=torch.bool).tril(-1)
    diag = lay & torch.eye(nb, dtype=torch.bool)
    return (float(below.sum().item()) + 0.5 * float(diag.sum().item())) * B


def sparse_case(sa, name, cfg, causal, dtype, shape=None, timed=False, seed=0,
                empty_block_row=None, view=None, route=None):
    """Kernel S against its fp32 plain version and the parent's build.
    ``view``: "strided" reads q/k/v as the first D columns of wider rows (8
    bytes apart past 16-byte multiples), "expand_kv" K and V of one head
    expanded over the heads (stride 0); ``route`` the copy route kernel S
    must take (0 TMA, else cp.async bytes)."""
    B, S, H, D = SPARSE_SHAPE if shape is None else shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    if view == "strided":
        q, k, v = (torch.randn((B, S, H, D + 4), generator=g, device=DEV).to(dtype)[..., :D]
                   for _ in range(3))
    elif view == "expand_kv":
        q = torch.randn((B, S, H, D), generator=g, device=DEV).to(dtype)
        k, v = (torch.randn((B, S, 1, D), generator=g, device=DEV).to(dtype).expand(B, S, H, D)
                for _ in range(2))
    else:
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=DEV).to(dtype)
                   for _ in range(3))
    wgmma = dtype != torch.float32 and D <= 256
    before = sa.sparse_attention.launches
    out = sa.sparse_attention(q, k, v, cfg, causal=causal)
    again = sa.sparse_attention(q, k, v, cfg, causal=causal)
    check(sa.sparse_attention.launches == before + 2,
          f"sparse {name}: {sa.sparse_attention.launches - before} launches for two calls")
    ref = sa.sparse_attention_plain(q.float(), k.float(), v.float(), cfg, causal)
    torch.cuda.synchronize()
    tol = SPARSE_TOL[dtype]
    err, atol_used, ok = max_err(out, ref, tol)
    layout = cfg.make_layout(S)
    rec = {"case": name, "shape": [B, S, H, D], "block": cfg.block, "dtype": str(dtype)[6:],
           "causal": causal, "layout_heads": int(layout.shape[0]),
           "layout_density": float(layout.mean()), "max_abs_err": err, "atol_used": atol_used,
           "tol": tol, "bit_equal_across_calls": torch.equal(out, again)}
    if wgmma:
        rec["copy_route"] = sa.copy_route(q, k, v)
        rec["key_tile"] = sa.cta_key_tile(sa.padded_head_dim(D), cfg.block % sa.CTA_ROWS != 0)
        rec["unit_masks"] = cfg.block % sa.CTA_ROWS != 0
    print(json.dumps({"sparse_check": rec}))
    check(bool(torch.isfinite(out).all()), f"sparse {name}: non-finite output")
    check(ok, f"sparse {name}: kernel vs fp32 plain beyond {tol} (max abs {err:.3g}, "
          f"atol used {atol_used:.3g})")
    check(rec["bit_equal_across_calls"], f"sparse {name}: outputs differ between two calls")
    if route is not None:
        check(rec.get("copy_route") == route,
              f"sparse {name}: copy route {rec.get('copy_route')}, not {route}")
    if empty_block_row is not None:
        rows = slice(empty_block_row * cfg.block, (empty_block_row + 1) * cfg.block)
        check(bool((out[:, rows] == 0).all()), f"sparse {name}: an empty layout row is not 0")
        rec["empty_row_zero"] = True

    def new():
        return sa.sparse_attention(q, k, v, cfg, causal=causal)

    def prev():  # the parent's library under today's wrapper
        return BASE.swapped("sparse_attention", new)

    if BASE is not None:
        same = torch.equal(prev(), out)
        check(same, f"sparse {name}: other bits than the parent's build")
        rec["bit_equal_to_previous"] = same
    if timed:
        lay_h = torch.as_tensor(layout, device=DEV).bool().expand(H, *layout.shape[1:])
        pairs = sparse_pairs(layout if layout.shape[0] == H else
                             layout.repeat(H, axis=0), causal, B)
        item = q.element_size()
        nbytes = 4 * q.numel() * item
        ops = 4.0 * D * cfg.block ** 2 * pairs
        b_ms, b_by = bound(nbytes, ops, dtype)
        blk = torch.ones((cfg.block, cfg.block), dtype=torch.bool, device=DEV)
        mask = torch.kron(lay_h.to(torch.int32), blk.to(torch.int32)) > 0  # [H, S, S]
        if causal:
            mask &= torch.ones((S, S), dtype=torch.bool, device=DEV).tril()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if BASE is not None:  # the parent's build on the same inputs, in turns
            rec["previous_ms"], ms, rec["turns_prev_new_new_prev"] = turns(prev, new)
        else:
            ms = device_ms(new)
        rec.update(
            ms=ms, bound_share=b_ms / ms,
            plain_ms=device_ms(lambda: sa.sparse_attention_plain(q, k, v, cfg, causal),
                               iters=5, warmup=2),
            library_ms=device_ms(lambda: sdpa(qh, kh, vh, mask[None], 1)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=ops, block_pairs=pairs)
        del mask
    print(json.dumps({"sparse": rec}))
    return rec


def sparse_phase(sa):
    """Kernel S at BERT-large's heads, S = 4096 (timed: the three default
    layouts, causal and not) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    H = SPARSE_SHAPE[2]
    recs = []
    for nm, cfg in sparse_configs(sa, H).items():
        for causal in (True, False):
            recs.append(sparse_case(sa, f"{nm}_{'causal' if causal else 'full'}", cfg, causal,
                                    bf16, timed=True))
    fixed = sparse_configs(sa, H)["fixed"]
    recs += [
        sparse_case(sa, "dense_causal", sa.DenseSparsityConfig(num_heads=4, block=128), True,
                    bf16, shape=(2, 1024, 4, 64)),
        sparse_case(sa, "fixed_fp16_d128", fixed, True, fp16, shape=(1, 2048, H, 128)),
        sparse_case(sa, "bigbird_fp32_d32", sparse_configs(sa, H)["bigbird"], False, fp32,
                    shape=(1, 1024, H, 32)),
        sparse_case(sa, "fixed_fp32_causal_d16", fixed, True, fp32, shape=(2, 512, H, 16)),
        sparse_case(sa, "bslongformer_heads_from_1", sa.BSLongformerSparsityConfig(
            num_heads=1, block=128), True, bf16, shape=(2, 2048, 8, 64)),
        sparse_case(sa, "bigbird_block_256", sa.BigBirdSparsityConfig(num_heads=4, block=256),
                    False, bf16, shape=(1, 2048, 4, 64)),
        sparse_case(sa, "empty_row_causal", empty_row_config(sa, 4, 3), True, bf16,
                    shape=(1, 1024, 4, 64), empty_block_row=3),
        sparse_case(sa, "empty_row_full_fp32", empty_row_config(sa, 4, 5), False, fp32,
                    shape=(1, 1024, 4, 64), empty_block_row=5),
        # head dim 80 (phi 2) at block 128
        sparse_case(sa, "fixed_d80", fixed, True, bf16, shape=(1, 1024, H, 80)),
        # blocks under the 64-row tile (DeepSpeed's GPU default is 16) and
        # off it (48), S not a multiple of 64
        sparse_case(sa, "fixed_block16_causal_d80", sa.FixedSparsityConfig(
            num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1), True, bf16,
            shape=(1, 1040, H, 80)),
        sparse_case(sa, "bigbird_block32_full", sa.BigBirdSparsityConfig(
            num_heads=H, block=32, num_random_blocks=2, num_sliding_window_blocks=3,
            num_global_blocks=1), False, bf16, shape=(1, 1056, H, 64)),
        sparse_case(sa, "bslongformer_block16_fp32", sa.BSLongformerSparsityConfig(
            num_heads=4, block=16, num_sliding_window_blocks=5, global_block_indices=(0, 7)),
            True, fp32, shape=(2, 528, 4, 32)),
        sparse_case(sa, "fixed_block48_fp16_d96", sa.FixedSparsityConfig(
            num_heads=4, block=48, num_local_blocks=3, num_global_blocks=1), False, fp16,
            shape=(1, 1008, 4, 96)),
        sparse_case(sa, "empty_row_block32", empty_row_config(sa, 4, 7, block=32), True, bf16,
                    shape=(1, 544, 4, 64), empty_block_row=7),
        # blocks off 16 (each element of a partly visible unit tested against
        # the layout) and head dims off 16 and past 128
        sparse_case(sa, "fixed_block8_causal", sa.FixedSparsityConfig(
            num_heads=4, block=8, num_local_blocks=4, num_global_blocks=1), True, bf16,
            shape=(1, 520, 4, 64)),
        sparse_case(sa, "bigbird_block24_full", sa.BigBirdSparsityConfig(
            num_heads=4, block=24, num_random_blocks=2), False, bf16, shape=(1, 600, 4, 64)),
        sparse_case(sa, "bslongformer_block24_fp32", sa.BSLongformerSparsityConfig(
            num_heads=4, block=24, num_sliding_window_blocks=3), True, fp32,
            shape=(1, 360, 4, 32)),
        sparse_case(sa, "fixed_d72", sa.FixedSparsityConfig(num_heads=4, block=128), True,
                    bf16, shape=(1, 1024, 4, 72)),
        sparse_case(sa, "fixed_d160_full", sa.FixedSparsityConfig(num_heads=4, block=128),
                    False, bf16, shape=(1, 1024, 4, 160)),
        # head dims past 256: the runtime-head-dim kernel
        *(sparse_case(sa, f"wide_d{D}_{nm}", sa.FixedSparsityConfig(
            num_heads=4, block=32, num_local_blocks=2, num_global_blocks=1), causal, dt,
            shape=(1, 256, 4, D)) for D in (288, 320, 512)
          for nm, dt, causal in (("bf16_causal", bf16, True), ("fp32_full", fp32, False))),
        sparse_case(sa, "wide_d320_bigbird_block24", sa.BigBirdSparsityConfig(
            num_heads=4, block=24, num_random_blocks=2), False, bf16, shape=(1, 264, 4, 320)),
        sparse_case(sa, "wide_d512_fixed_s4096", fixed, True, bf16, shape=(1, 4096, H, 512),
                    timed=True),
        # block 64 (two layout rows per 128-row query tile: unit masks), and
        # DeepSpeed's GPU default block 16 at the main shape, timed
        sparse_case(sa, "bigbird_block64_causal", sa.BigBirdSparsityConfig(
            num_heads=H, block=64, num_random_blocks=2), True, bf16, shape=(1, 1024, H, 64)),
        sparse_case(sa, "fixed_block16_causal_s4096", sa.FixedSparsityConfig(
            num_heads=H, block=16, num_local_blocks=8, num_global_blocks=1), True, bf16,
            timed=True),
        # q/k/v that TMA cannot read in place: rows 8 bytes past 16-byte
        # multiples, and K/V of one head expanded over the heads (stride 0)
        sparse_case(sa, "strided_rows_cp8", fixed, True, bf16, shape=(1, 1024, H, 64),
                    view="strided", route=8),
        sparse_case(sa, "expand_kv_cp16_fp16", fixed, False, fp16, shape=(1, 1024, H, 64),
                    view="expand_kv", route=16),
        sparse_case(sa, "strided_rows_cp8_block24", sa.BigBirdSparsityConfig(
            num_heads=4, block=24, num_random_blocks=2), True, bf16, shape=(1, 600, 4, 64),
            view="strided", route=8),
    ]
    # the path: a user's calls of the entry point at the main shape, the
    # three default layouts causal and not, counter zeroed before, read after
    B, S, H, D = SPARSE_SHAPE
    g = torch.Generator(device=DEV).manual_seed(11)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=DEV).to(bf16) for _ in range(3))
    calls = [(cfg, causal) for cfg in sparse_configs(sa, H).values() for causal in (True, False)]
    torch.cuda.synchronize()
    sa.sparse_attention.launches = 0
    outs = [sa.sparse_attention(q, k, v, cfg, causal=causal) for cfg, causal in calls]
    torch.cuda.synchronize()
    launches = sa.sparse_attention.launches
    check(launches == len(calls) and all(
        o.shape == q.shape and bool(torch.isfinite(o).all()) for o in outs),
        f"sparse path: {launches} launches for {len(calls)} calls, or a bad output")
    recs[0]["path_launches"] = launches
    # the same six calls under the profiler: the wgmma kernel once per call
    names = profiled_kernels(lambda: [sa.sparse_attention(q, k, v, cfg, causal=causal)
                                      for cfg, causal in calls])
    recs[0]["path_kernels"] = names
    check(sum(n for k, n in names.items() if "sparse_attn_wgmma_kernel" in k) == len(calls),
          f"sparse path: the profiler saw {names}, not {len(calls)} wgmma launches")
    # the kernel has no backward (nor has the JAX one): inputs that require
    # a gradient raise on the card
    q = torch.randn((1, 256, H, 64), device=DEV, dtype=bf16, requires_grad=True)
    try:
        sa.sparse_attention(q, q, q, fixed)
    except NotImplementedError as e:
        recs[0]["grad_raises"] = str(e)[:80]
    else:
        check(False, "sparse: a CUDA call with inputs that require grad did not raise")
    return recs


# -- phase 19: kernels E, E', E'', evoformer attention ------------------------

#: Kernels E, E', E'' against their plain versions computed in fp32 from the
#: same inputs (the backward from the kernel's own lse and delta, as in
#: phase 6).  rtol is each output's rounding (2^-8 bf16, 2^-11 fp16, 2^-24
#: fp32; the kernels' bias gradients are fp32: 2^-20, a few ulps).  atol is
#: about twice the largest need observed on an H100 (PERF.md).  E rounds P
#: to the input type as the PV operand, as flash does (need 1.94e-3 bf16,
#: 1.96e-4 fp16, 2.5e-6 fp32).  E' and E'' round P and dS as tensor-core
#: operands (1.43e-2 bf16 dV, 1.25e-3 fp16; none beyond rtol in fp32).
#: Phase 20 holds the training call's gradients, in the inputs' and biases'
#: bf16, to the same EVO_BWD_TOL against fp32 autograd of the formulation;
#: there delta comes from the bf16-rounded output, and dbias1 sums that
#: over 3,072 (h, q) rows per key (need 6.5e-2 at |dbias1| up to ~50),
#: which sets the bf16 limit.  The fp32 bias gradients of E' and E'' are
#: sums in another order over up to 4,096 terms (1.6e-5 bf16 inputs, 7.7e-6
#: fp16, 2e-6 fp32).
EVO_TOL = {torch.bfloat16: (4e-3, 2.0 ** -8), torch.float16: (4e-4, 2.0 ** -11),
           torch.float32: (5e-6, 2.0 ** -24)}
EVO_BWD_TOL = {torch.bfloat16: (1.3e-1, 2.0 ** -8), torch.float16: (2.5e-3, 2.0 ** -11),
               torch.float32: (1e-5, 2.0 ** -24)}
EVO_DBIAS_TOL = {torch.bfloat16: (4e-5, 2.0 ** -20), torch.float16: (2e-5, 2.0 ** -20),
                 torch.float32: (5e-6, 2.0 ** -20)}
EVO_LSE_TOL = 1e-4  # plus 2^-22 relative: a -1e9-masked row's lse is ~-1e9
#: AlphaFold 2's MSA row attention with pair bias at the fine-tuning crop
#: (Jumper et al. 2021, Suppl. Alg. 7, Table 4): B, S = N_seq, N = N_res, H, D
EVO_MAIN = (1, 512, 384, 8, 32)
#: triangle attention at the same crop (Alg. 13-14): S = N = 384, H = 4
EVO_TRIANGLE = (1, 384, 384, 4, 32)


def evo_inputs(shape, dtype, biases, seed, K=None, masked_row=None):
    """q, k, v, dO in ``dtype``; bias1 [B,S,1,1,K] / bias2 [B,1,H,Q,K] in
    ``dtype`` per ``biases`` ("b1", "b2"); ``masked_row`` (b, s) gets
    AlphaFold's 1e9 * (mask - 1) = -1e9 on every key in bias1."""
    B, S, N, H, D = shape
    K = N if K is None else K
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, S, N, H, D), generator=g, device=DEV).to(dtype)
    k, v = (torch.randn((B, S, K, H, D), generator=g, device=DEV).to(dtype) for _ in range(2))
    do = torch.randn((B, S, N, H, D), generator=g, device=DEV).to(dtype)
    b1 = b2 = None
    if "b1" in biases:
        b1 = torch.randn((B, S, 1, 1, K), generator=g, device=DEV)
        if masked_row is not None:
            b1[masked_row] = -1e9
        b1 = b1.to(dtype)
    if "b2" in biases:
        b2 = torch.randn((B, 1, H, N, K), generator=g, device=DEV).to(dtype)
    return q, k, v, do, b1, b2


def evo_case(ev, name, shape, dtype, biases=("b1", "b2"), K=None, masked_row=None,
             timed=False, seed=0, resident=None):
    """Kernels E, E', E'' against their fp32 plain versions and the parent's
    build; ``resident``: whether E' must keep K and V resident per head."""
    B, S, N, H, D = shape
    q, k, v, do, b1, b2 = evo_inputs(shape, dtype, biases, seed, K, masked_row)
    K = k.shape[2]
    b1f = None if b1 is None else b1.reshape(B, S, K).float()
    b2f = None if b2 is None else b2.reshape(B, H, N, K).float()
    counts = [f.launches for f in (ev.evoformer_attn_fwd, ev.evoformer_attn_bwd_dq,
                                   ev.evoformer_attn_bwd_dkv)]
    o, lse = ev.evoformer_attn_fwd(q, k, v, b1f, b2f)
    delta = ev._delta(o, do)
    dq, db1 = ev.evoformer_attn_bwd_dq(q, k, v, do, lse, delta, b1f, b2f)
    dk, dv, db2 = ev.evoformer_attn_bwd_dkv(q, k, v, do, lse, delta, b1f, b2f)
    check([f.launches for f in (ev.evoformer_attn_fwd, ev.evoformer_attn_bwd_dq,
                                ev.evoformer_attn_bwd_dkv)] == [c + 1 for c in counts],
          f"evo {name}: not one launch of each kernel")
    o_ref, lse_ref = ev.evoformer_attn_fwd_plain(q.float(), k.float(), v.float(), b1f, b2f)
    grads_ref = ev.evoformer_attn_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                                            delta, b1f, b2f)
    torch.cuda.synchronize()
    rec = {"case": name, "shape": [B, S, N, K, H, D], "dtype": str(dtype)[6:],
           "biases": list(biases), "masked_row": masked_row, "tol": EVO_TOL[dtype],
           "bwd_tol": EVO_BWD_TOL[dtype], "dbias_tol": EVO_DBIAS_TOL[dtype]}
    err, atol_used, ok = max_err(o, o_ref, EVO_TOL[dtype])
    lse_err = (lse - lse_ref).abs()
    lse_ok = bool((lse_err <= EVO_LSE_TOL + 2.0 ** -22 * lse_ref.abs()).all())
    rec.update(o_max_abs_err=err, o_atol_used=atol_used, lse_max_abs_err=lse_err.max().item())
    check(bool(torch.isfinite(o).all()), f"evo {name}: non-finite output")
    check(ok, f"evo {name}: E vs fp32 plain beyond {EVO_TOL[dtype]} (max abs {err:.3g}, "
          f"atol used {atol_used:.3g})")
    check(lse_ok, f"evo {name}: lse beyond {EVO_LSE_TOL} (max abs {rec['lse_max_abs_err']:.3g})")
    for nm, out, want in zip(("dq", "dk", "dv", "db1", "db2"), (dq, dk, dv, db1, db2),
                             grads_ref):
        check((out is None) == (want is None), f"evo {name}: {nm} presence differs")
        if out is None:
            continue
        tol = EVO_DBIAS_TOL[dtype] if nm.startswith("db") else EVO_BWD_TOL[dtype]
        e, used, good = max_err(out, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"] = e, used
        rec[f"{nm}_ref_max_abs"] = want.abs().max().item()
        check(bool(torch.isfinite(out).all()), f"evo {name}: non-finite {nm}")
        # a row masked by -1e9 is held in the forward only: its fp32 lse
        # cannot hold log K, so the backward's P = exp(s - lse) sums to K on
        # that row in the TPU kernels, the port's kernels and the plain
        # version alike (ROADMAP Queue 3), and its gradients are K times too
        # large for any limit scaled to a normal row
        check(good or masked_row is not None, f"evo {name}: {nm} vs fp32 plain beyond {tol} "
              f"(max abs {e:.3g}, atol used {used:.3g})")
    # no atomics: a second backward gives the same bits
    again = (*ev.evoformer_attn_bwd_dq(q, k, v, do, lse, delta, b1f, b2f),
             *ev.evoformer_attn_bwd_dkv(q, k, v, do, lse, delta, b1f, b2f))
    torch.cuda.synchronize()
    same = all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip((dq, db1, dk, dv, db2), again))
    check(same, f"evo {name}: gradients differ between two calls")
    rec["bit_equal_across_calls"] = same
    if BASE is not None:
        # E, E' and E'' are the parent's build's: the same bits from the
        # same inputs (and lse, delta)
        prev = BASE.swapped("evoformer_attn", lambda: (
            *ev.evoformer_attn_fwd(q, k, v, b1f, b2f),
            *ev.evoformer_attn_bwd_dq(q, k, v, do, lse, delta, b1f, b2f),
            *ev.evoformer_attn_bwd_dkv(q, k, v, do, lse, delta, b1f, b2f)))
        torch.cuda.synchronize()
        same = all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip((o, lse, dq, db1, dk, dv, db2), prev))
        check(same, f"evo {name}: E, E' or E'' give other bits than the parent's build")
        rec["bit_equal_to_previous"] = same
    rec["fwd_stages"] = ev.fwd_stages(q.dtype, K, D, b2f is not None)
    if "past_resident" in name:
        check(rec["fwd_stages"] == 0, f"evo {name}: the pair bias was kept resident")
    if timed:
        check(rec["fwd_stages"] > 0, f"evo {name}: E did not keep the pair bias resident")
    rec["qranges"] = ev.dkv_query_ranges(q.dtype, N, D, b2f is not None)
    plan = ev.dq_plan(q.dtype, B, S, N, K, H, D, b1f is not None, b2f is not None)
    rec["dq_plan"] = plan._asdict()
    rec["kranges"] = plan.kranges
    if name.startswith("key_ranges"):
        check(rec["kranges"] > 1, f"evo {name}: E' did not cut the key axis")
    if resident is not None:
        check(plan.resident == int(resident),
              f"evo {name}: E' plan {plan}, K/V resident should be {resident}")
    rec["max_abs_err"] = err
    if masked_row is None:  # the gradients held to their limits
        rec["bwd_max_abs_err"] = max(rec[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv"))
    if masked_row is not None:
        # AlphaFold's fully masked row: every score is -1e9 in fp32, the
        # softmax uniform, and the output the plain version's
        bm, sm = masked_row
        rec["masked_row_o_max_abs_err"] = (o[bm, sm].float() - o_ref[bm, sm]).abs().max().item()
    print(json.dumps({"evo_check": rec}))
    if timed:
        item = q.element_size()
        pairs = float(B * S * H * N * K)
        qkvo = (q.numel() + k.numel() + v.numel() + o.numel()) * item
        bias_b = sum(t.numel() * 4 for t in (b1f, b2f) if t is not None)
        stats = 2 * lse.numel() * 4
        f_b, f_by = bound(qkvo + lse.numel() * 4 + bias_b, 4.0 * D * pairs, dtype)
        # q, k, v, dO (dO the size of o) in; dq, or dk and dv, out
        dq_b, dq_by = bound(qkvo + q.numel() * item + stats + bias_b
                            + (0 if b1f is None else b1f.numel() * 4), 6.0 * D * pairs, dtype)
        dkv_b, dkv_by = bound(qkvo + 2 * k.numel() * item + stats + bias_b
                              + (0 if b2f is None else b2f.numel() * 4), 8.0 * D * pairs, dtype)
        # SDPA yardstick: [B*S, H, N, D] views, the biases summed into one float mask
        qh, kh, vh = (t.reshape(B * S, t.shape[2], H, D).transpose(1, 2).detach()
                      .requires_grad_() for t in (q, k, v))
        doh = do.reshape(B * S, N, H, D).transpose(1, 2)
        mask = torch.zeros((B, S, H, N, K), device=DEV)
        for t in (b1f[:, :, None, None] if b1f is not None else None,
                  b2f[:, None] if b2f is not None else None):
            if t is not None:
                mask += t
        mask = mask.reshape(B * S, H, N, K).to(dtype)
        mask_g = mask.detach().requires_grad_()

        def lib_fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

        def lib_fwd_bwd_bias():
            # the same function as E' + E'': SDPA's backward with the float
            # mask requiring grad returns dS summed nowhere; two sums reduce
            # it to dbias1 [B, S, K] and dbias2 [B, H, Q, K]
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask_g)
            g = torch.autograd.grad(out, (qh, kh, vh, mask_g), doh)[3].reshape(B, S, H, N, K)
            return g.float().sum((2, 3)), g.float().sum(1)

        with torch.no_grad():
            lib_f = device_ms(lib_fwd)
        lib_fb = device_ms(lib_fwd_bwd)
        try:
            lib_fbb = device_ms(lib_fwd_bwd_bias, iters=5, warmup=2)
        except (RuntimeError, NotImplementedError) as e:  # no backend returns the mask's grad
            lib_fbb = None
            rec["library_bias_error"] = f"{type(e).__name__}: {str(e)[:300]}"
        del mask, mask_g

        def new_fwd():
            return ev.evoformer_attn_fwd(q, k, v, b1f, b2f)

        def new_dkv():
            return ev.evoformer_attn_bwd_dkv(q, k, v, do, lse, delta, b1f, b2f)

        def new_dq():
            return ev.evoformer_attn_bwd_dq(q, k, v, do, lse, delta, b1f, b2f)

        if BASE is not None:
            # the parent's E, E' and E'' on the same inputs, timed in turns
            rec["previous_fwd_ms"], fwd_ms, rec["turns_prev_new_new_prev"] = turns(
                lambda: BASE.swapped("evoformer_attn", new_fwd), new_fwd)
            rec["previous_dq_ms"], dq_ms, rec["dq_turns_prev_new_new_prev"] = turns(
                lambda: BASE.swapped("evoformer_attn", new_dq), new_dq)
            rec["previous_dkv_ms"], dkv_ms, rec["dkv_turns_prev_new_new_prev"] = turns(
                lambda: BASE.swapped("evoformer_attn", new_dkv), new_dkv)
        else:
            fwd_ms, dq_ms, dkv_ms = device_ms(new_fwd), device_ms(new_dq), device_ms(new_dkv)
        lib_bwd_bias = None if lib_fbb is None else lib_fbb - lib_f
        rec.update(
            library_bwd_bias_ms=lib_bwd_bias,
            fwd_ms=fwd_ms, fwd_bound_share=f_b / fwd_ms,
            dq_ms=dq_ms, dq_bound_share=dq_b / dq_ms,
            dq_dkv_ms=dq_ms + dkv_ms,
            dq_dkv_vs_library=None if lib_bwd_bias is None else (dq_ms + dkv_ms) / lib_bwd_bias,
            dkv_ms=dkv_ms, dkv_bound_share=dkv_b / dkv_ms,
            dkv_query_ranges=ev.dkv_query_ranges(q.dtype, N, D, b2f is not None),
            fwd_plain_ms=device_ms(lambda: ev.evoformer_attn_fwd_plain(q, k, v, b1f, b2f),
                                   iters=3, warmup=1),
            bwd_plain_ms=device_ms(lambda: ev.evoformer_attn_bwd_plain(
                q, k, v, do, lse, delta, b1f, b2f), iters=3, warmup=1),
            library_fwd_ms=lib_f, library_bwd_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
            fwd_bound_ms=f_b, fwd_bound_by=f_by, dq_bound_ms=dq_b, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by, pairs=pairs)
    print(json.dumps({"evo": rec}))
    return rec


def dq_resident_limit(ev, D):
    """The last K (a multiple of E''s key tile) at which E' in bf16 with
    both biases keeps a head's K and V tiles resident, as its plan says."""
    bk = 64 if D <= 64 else 32
    K = bk
    while ev.dq_plan(torch.bfloat16, 1, 4, 128, K + bk, 2, D, True, True).resident:
        K += bk
    return K


def evo_phase(ev):
    """Kernels E, E', E'' at AlphaFold 2's MSA row attention with pair bias
    and its triangle attention (timed) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    B, S, N, H, D = EVO_MAIN
    return [
        evo_case(ev, "msa_row_pair_bias", EVO_MAIN, bf16, timed=True),
        evo_case(ev, "triangle", EVO_TRIANGLE, bf16, timed=True),
        evo_case(ev, "no_bias", (1, 64, N, H, D), bf16, biases=()),
        evo_case(ev, "bias1_only", (1, 64, N, H, D), bf16, biases=("b1",)),
        evo_case(ev, "pair_bias_only", (1, 64, N, H, D), bf16, biases=("b2",)),
        evo_case(ev, "d16", (2, 16, 256, 4, 16), bf16),
        evo_case(ev, "d64", (1, 32, 256, 8, 64), bf16),
        evo_case(ev, "d128", (1, 16, 256, 4, 128), bf16),
        evo_case(ev, "ragged_n300", (1, 32, 300, 8, 32), bf16),
        evo_case(ev, "ragged_q200_k300_d64", (2, 8, 200, 4, 64), bf16, K=300),
        evo_case(ev, "fp16", (1, 32, 256, 8, 32), fp16),
        evo_case(ev, "fp32", (1, 16, 200, 4, 32), fp32),
        evo_case(ev, "fp32_d128_bias1", (1, 8, 130, 2, 128), fp32, biases=("b1",)),
        # D = 64 and 128 with bias1 only, and D = 64 at 128 keys: the
        # resident-bias kernel (D = 64 and 128 with a wider pair bias take the
        # tile kernel)
        evo_case(ev, "d64_bias1_only", (1, 16, 300, 8, 64), bf16, biases=("b1",)),
        evo_case(ev, "d64_k128", (1, 16, 128, 4, 64), bf16),
        evo_case(ev, "d128_bias1_only", (1, 8, 200, 4, 128), bf16, biases=("b1",)),
        # past the keys whose pair-bias rows fit a block: the tile kernel
        evo_case(ev, "k700_past_resident_bias2", (1, 4, 100, 4, 32), bf16, K=700),
        # an odd count of MSA rows: warpgroup 1 of the last block has fewer
        evo_case(ev, "odd_s3_ragged_n130", (1, 3, 130, 2, 32), bf16),
        evo_case(ev, "fp16_bias1_only_d16", (1, 8, 100, 2, 16), fp16, biases=("b1",)),
        evo_case(ev, "masked_row", (1, 16, 256, 8, 32), bf16, masked_row=(0, 5)),
        evo_case(ev, "masked_row_fp32", (1, 8, 100, 4, 16), fp32, masked_row=(0, 3)),
        # past the residues whose whole dbias2 accumulator fits a block: E''
        # cuts the query axis into ranges (ROADMAP Queue 3 #F1)
        evo_case(ev, "ranges_n640_bf16", (1, 8, 640, 4, 32), bf16),
        evo_case(ev, "ranges_n300_fp32_d128", (1, 4, 300, 2, 128), fp32),
        # past the keys whose whole dbias1 accumulator fits a block: E' cuts
        # the key axis into ranges (ROADMAP Queue 3 #F1, closed)
        evo_case(ev, "key_ranges_k6000_bf16_d128", (1, 2, 64, 2, 128), bf16, K=6000),
        evo_case(ev, "key_ranges_k16000_fp32_d128", (1, 1, 64, 2, 128), fp32, K=16000,
                 biases=("b1",)),
        # E' at the last K whose K/V tiles stay resident per head and one key
        # past it (K/V streamed through a ring), D = 32 and 128
        *(evo_case(ev, f"{'resident' if r else 'streamed'}_k{Kr + (0 if r else 1)}_d{Dr}",
                   (1, 4, 128, 2, Dr), bf16, K=Kr + (0 if r else 1), resident=r)
          for Dr in (32, 128) for Kr in (dq_resident_limit(ev, Dr),) for r in (True, False)),
    ]


# -- phase 20: the evoformer training path ------------------------------------

def _evo_step(fn, args, g):
    """out = fn(*args); (out * g).sum().backward(); returns the five grads."""
    for t in args[:3] + tuple(args[3]):
        t.grad = None
    out = fn(*args)
    (out.float() * g).sum().backward()
    return [t.grad for t in args[:3]] + [b.grad for b in args[3]]


def evo_train_phase(ev):
    """``DS4Sci_EvoformerAttention(q, k, v, [b1, b2])`` -> ``backward`` at
    AlphaFold 2's MSA row attention (bf16): one E, E' and E'' launch per
    call and no plain call, the five gradients within EVO_BWD_TOL of plain
    autograd through ``evoformer_attention_xla`` in fp32 on the same inputs,
    bit-equal across two calls, and a peak memory below what the scores
    alone would take."""
    dtype = torch.bfloat16
    B, S, N, H, D = EVO_MAIN
    q, k, v, do, b1, b2 = evo_inputs(EVO_MAIN, dtype, ("b1", "b2"), seed=3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    biases = [b1.detach().requires_grad_(), b2.detach().requires_grad_()]
    g = do.float()
    scores_bytes = 4.0 * B * S * H * N * N
    counters = (ev.evoformer_attn_fwd, ev.evoformer_attn_bwd_dq, ev.evoformer_attn_bwd_dkv)

    def kernel_call():
        return _evo_step(ev.DS4Sci_EvoformerAttention, (*leaves, biases), g)

    kernel_call()  # warm-up (builds, caches)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    ev.evoformer_attention.plain_calls = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = [t.clone() for t in kernel_call()]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    launches = {c.__name__: c.launches for c in counters}
    check(launches == {"evoformer_attn_fwd": 1, "evoformer_attn_bwd_dq": 1,
                       "evoformer_attn_bwd_dkv": 1} and ev.evoformer_attention.plain_calls == 0,
          f"evo train: launches {launches}, plain calls {ev.evoformer_attention.plain_calls}")
    again = kernel_call()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "evo train: gradients differ between two calls")
    # the profiler names the kernels of a call: E, E' and E'' on wgmma
    names = profiled_kernels(kernel_call)
    for kern in ("evo_fwd_wgmma_kernel", "evo_bwd_dq_wgmma_kernel", "evo_bwd_dkv_wgmma_kernel"):
        check(sum(n for k, n in names.items() if kern in k) == 1,
              f"evo train: the profiler saw {names}, not one {kern}")
    check(peak < scores_bytes, f"evo train: kernel path peak {peak / 1e9:.3f} GB is not below "
          f"the {scores_bytes / 1e9:.3f} GB of the scores")
    check([tuple(t.shape) for t in grads[3:]] == [tuple(b1.shape), tuple(b2.shape)]
          and all(t.dtype == dtype for t in grads), "evo train: bias gradient shape or dtype")

    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref_biases = [t.detach().float().requires_grad_() for t in (b1, b2)]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref = _evo_step(ev.evoformer_attention_xla, (*ref_leaves, ref_biases), g)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - base
    rec = {"shape": [B, S, N, H, D], "dtype": "bfloat16", "launches": launches,
           "kernels": names,
           "plain_calls": 0, "bit_equal_across_calls": True, "wall_ms": wall_ms,
           "peak_gb": peak / 1e9, "plain_peak_gb": plain_peak / 1e9,
           "scores_gb": scores_bytes / 1e9, "tol": EVO_BWD_TOL[dtype]}
    for nm, got, want in zip(("dq", "dk", "dv", "db1", "db2"), grads, ref):
        tol = EVO_BWD_TOL[dtype]
        e, used, good = max_err(got, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"] = e, used
        rec[f"{nm}_ref_max_abs"] = want.abs().max().item()
        check(good, f"evo train: {nm} vs fp32 xla autograd beyond {tol} (max abs {e:.3g}, "
              f"atol used {used:.3g})")
    rec["kernel_fwd_bwd_ms"] = device_ms(kernel_call, iters=5, warmup=1)
    rec["plain_fwd_bwd_ms"] = device_ms(
        lambda: _evo_step(ev.evoformer_attention_xla, (*ref_leaves, ref_biases), g),
        iters=3, warmup=1)
    del ref, ref_leaves, ref_biases
    torch.cuda.empty_cache()
    print(json.dumps({"evo_train": rec}))
    return rec



# -- phases 24-30: ZeRO-Offload, SuperOffload, ZenFlow, offload_param, the
# hybrid engine, the other optimizers and cpu_checkpointing -----------------

OFFLOAD_SEQ, OFFLOAD_MICRO, OFFLOAD_STEPS = 1024, 2, 4
#: host RAM left beside the offload state: the process (torch, the CUDA
#: context), the pinned staging buckets (1.5 GB at llama-7b), the page cache
OFFLOAD_HOST_MARGIN = 10 * 2**30
NVME_DIR = os.path.join(ROOT, "build", "nvme")


def meminfo(key: str) -> int:
    """A /proc/meminfo (or /proc/self/status) field in bytes."""
    path = "/proc/self/status" if key.startswith("Vm") else "/proc/meminfo"
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


def cpu_model() -> str:
    """The host CPU as lscpu names it, with its family/model numbers and
    core count (the model name may read "unknown" in a VM)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    f = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    g = lambda k: f.get(k, "?").strip()  # noqa: E731
    isa = "AVX-512" if "avx512f" in g("Flags") else ("AVX2" if "avx2" in g("Flags") else "")
    return (f"{g('Vendor ID')} {g('Model name')} (family {g('CPU family')} model "
            f"{g('Model')}), {g('CPU(s)')} cores, {isa}")


def host_triad_gbps(gib: int = 1) -> float:
    """The host's memory rate by a STREAM-style triad a = b + 3 c over
    ``gib`` GiB arrays on every core (torch's threads set to the core
    count): bytes read plus bytes written per second, best of 5."""
    b = torch.ones(gib << 28, dtype=torch.float32)
    c, a = torch.ones_like(b), torch.empty_like(b)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    best = 0.0
    try:
        for _ in range(5):
            t = time.perf_counter()
            torch.add(b, c, alpha=3.0, out=a)
            best = max(best, 3 * b.numel() * 4 / (time.perf_counter() - t) / 1e9)
    finally:
        torch.set_num_threads(threads)
    return best


def llama_params(cfg) -> int:
    H, D, L = cfg.hidden_size, cfg.head_dim, cfg.n_layers
    layer = (H * D * (cfg.n_heads + 2 * cfg.kv_heads) + cfg.n_heads * D * H
             + 3 * H * cfg.ffn_size + 2 * H)
    return cfg.vocab_size * H * 2 + L * layer + H


def offload_config(device, nvme_path=None, micro=OFFLOAD_MICRO, **extra):
    """The ZeRO-Offload config of the main path: bf16, AdamW (lr 1e-4, weight
    decay 0.1), clipping 1.0, stage 2 with the optimizer on the host,
    bf16 gradient accumulation (bench.py:181's setting for large models)."""
    off = {"device": device, "pin_memory": True}
    if nvme_path:
        off["nvme_path"] = nvme_path
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
           "bf16": {"enabled": True}, "zero_optimization": {"stage": 2, "offload_optimizer": off},
           "gradient_clipping": 1.0, "data_types": {"grad_accum_dtype": "bf16"}}
    for k, v in extra.items():
        if k == "zero_optimization":
            cfg[k].update(v)
        else:
            cfg[k] = v
    return cfg


def offload_plan(cfg):
    """cpu when master and moments fit MemAvailable; else nvme (master in
    RAM, moments on disk) when the master fits and the disk holds the
    moments; else the depth cut until cpu fits.  (mode, layers, reduced)."""
    n = llama_params(cfg)
    avail = meminfo("MemAvailable")
    os.makedirs(NVME_DIR, exist_ok=True)
    disk = shutil.disk_usage(NVME_DIR).free
    if avail >= 12 * n + OFFLOAD_HOST_MARGIN:
        return "cpu", cfg.n_layers, None, avail, disk
    if avail >= 4 * n + OFFLOAD_HOST_MARGIN and disk >= 8.5 * n:
        return "nvme", cfg.n_layers, None, avail, disk
    per_layer = (llama_params(cfg) - llama_params(dataclasses.replace(cfg, n_layers=0))) \
        // cfg.n_layers
    for L in range(cfg.n_layers - 1, 0, -1):
        if avail >= 12 * (n - (cfg.n_layers - L) * per_layer) + OFFLOAD_HOST_MARGIN:
            return "cpu", L, (f"layers {cfg.n_layers} -> {L}: MemAvailable "
                              f"{avail / 2**30:.1f} GB, disk {disk / 2**30:.1f} GB"), avail, disk
    raise SmokeFailure(f"offload: no depth fits MemAvailable {avail / 2**30:.1f} GB")


def boundary_timed(engine):
    """Wrap the engine's offload boundary so each step's boundary wall ms is
    kept (the rest of the step is the forward and backward)."""
    spans = []
    inner = engine._apply_step_offload

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(*a, **kw)
        torch.cuda.synchronize()
        spans.append({"boundary_ms": (time.perf_counter() - t) * 1e3,
                      **engine._boundary.timings()})

    engine._apply_step_offload = timed
    return spans


def offload_7b_phase(fa, fadam):
    """Phase 24: llama-7b at full width (full depth unless host RAM and disk
    force a cut) through initialize -> train_batch with the fp32 master and
    the Adam moments in host RAM (or the moments on NVMe): OFFLOAD_STEPS
    steps on one seeded batch, the loss must fall; no fp32 master or
    moment on the card; A, A' and A'' at D = 128 every layer every step."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config, llama_model
    from deepspeed_tpu_torch.models.transformer import flops_per_token

    full = llama_config("7b", max_seq_len=OFFLOAD_SEQ)
    mode, L, reduced, avail, disk = offload_plan(full)
    print(json.dumps({"offload_plan": {"mode": mode, "layers": L, "reduced": reduced,
                                       "mem_available_gb": avail / 2**30,
                                       "disk_free_gb": disk / 2**30}}))
    if reduced:
        print(json.dumps({"reduced": reduced}))
    model = llama_model("7b", max_seq_len=OFFLOAD_SEQ, n_layers=L)
    cfg = model.config
    n_expect = llama_params(cfg)
    torch.cuda.synchronize()
    rss0 = meminfo("VmRSS")
    base = torch.cuda.memory_allocated()  # what earlier phases left on the card
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=offload_config(mode, NVME_DIR if mode == "nvme" else None), seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = engine.offload_optimizer
    n_params = sum(p.numel() for p in engine._compute_leaves)
    check(n_params == n_expect, f"offload 7b: {n_params} params, expected {n_expect}")
    check(engine._master == [] and engine.state.opt_state == () and
          all(p.device.type == engine.device.type and p.dtype == torch.bfloat16
              for p in engine._compute_leaves),
          "offload 7b: an fp32 master or optimizer state is on the card")
    resident_gb = (torch.cuda.memory_allocated() - base) / 2**30
    check(resident_gb <= (2 * n_params + 2**30) / 2**30,
          f"offload 7b: {resident_gb:.2f} GB resident after init, more than the bf16 weights")
    g = torch.Generator(device=DEV).manual_seed(123)
    batch = torch.randint(0, cfg.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ), generator=g,
                          device=DEV)
    spans = boundary_timed(engine)
    torch.cuda.reset_peak_memory_stats()
    zero_train_counters(fa, fadam)
    losses, step_ms, _ = timed_steps(engine, batch, OFFLOAD_STEPS)
    launches = read_train_counters(fa, fadam)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    check(all(map(math.isfinite, losses)), f"offload 7b: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"offload 7b: loss did not fall: {losses}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * OFFLOAD_STEPS,
              f"offload 7b: {k} launches {launches[k]} != {L} x {OFFLOAD_STEPS}")
    check(launches["fused_adam"] == 0, "offload 7b: the device Adam ran")
    steady = list(range(1, OFFLOAD_STEPS))  # step 0 also faults the moments in
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    parts = {k: med([spans[i][k] for i in steady]) for k in spans[0]}
    step = med([step_ms[i] for i in steady])
    fwd_bwd = med([step_ms[i] - spans[i]["boundary_ms"] for i in steady])
    tokens = OFFLOAD_MICRO * OFFLOAD_SEQ
    fpt = flops_per_token(cfg, OFFLOAD_SEQ)
    triad_gbps = host_triad_gbps()
    adam_bytes = 28 * n_params  # p, m, v read and written, g read, fp32
    rec = {"model": "llama-7b", "layers": L, "mode": mode, "reduced": reduced,
           "params": n_params, "seq": OFFLOAD_SEQ, "micro_batch": OFFLOAD_MICRO, "dtype": "bf16",
           "init_s": init_s, "losses": losses, "step_ms": step_ms, "median_step_ms": step,
           "fwd_bwd_ms": fwd_bwd, "boundary_parts_ms": parts,
           "host_opt_gbps": adam_bytes / (parts["host_opt_ms"] / 1e3) / 1e9,
           "host_opt_bytes": adam_bytes, "host_triad_gbps": triad_gbps,
           "host_opt_bound_ms": adam_bytes / (triad_gbps * 1e9) * 1e3,
           "tokens_per_s": tokens / (step / 1e3),
           "mfu": fpt * tokens / (step / 1e3) / PEAK_OPS[torch.bfloat16],
           "peak_mem_gb": peak_gb, "peak_above_base_gb": peak_gb - base / 2**30,
           "base_gb": base / 2**30, "resident_after_init_gb": resident_gb,
           "master_bytes": opt.master_bytes(), "moment_bytes": opt.moment_bytes(),
           "pinned_bytes": engine._boundary.pinned_bytes(),
           "rss_gb": meminfo("VmRSS") / 2**30, "rss_before_gb": rss0 / 2**30,
           "cpu": cpu_model(), "launches": launches}
    check(mode != "cpu" or opt.moment_bytes() == 8 * n_params,
          "offload 7b: the moments are not all in host RAM")
    engine._apply_step_offload = None
    opt.close()
    del engine, opt, losses
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(NVME_DIR, ignore_errors=True)
    print(json.dumps({"offload_7b": rec}))
    return rec


def host_ops_phase():
    """Phase 25: the host ops alone on one llama-7b MLP leaf (4096 x 11008
    fp32): cpu_adam, cpu_lion, cpu_adagrad and torch._fused_adamw_ on CPU
    tensors, each beside its bound: its bytes over the host's memory rate,
    the fastest of a STREAM-style triad on every core and the ops measured
    here (``host_bound_gbps``, ``bound_by`` names which); the async-I/O
    engine writing and reading the leaf's two moments."""
    from deepspeed_tpu_torch.ops.cpu.adagrad import DeepSpeedCPUAdagrad
    from deepspeed_tpu_torch.ops.cpu.adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.ops.cpu.aio import AsyncIOHandle
    from deepspeed_tpu_torch.ops.cpu.lion import DeepSpeedCPULion

    n = 4096 * 11008
    rng = torch.Generator().manual_seed(5)
    p = torch.randn(n, generator=rng)
    gr = torch.randn(n, generator=rng) * 1e-3
    triad_gbps = host_triad_gbps()

    def best_ms(fn, reps=5):
        fn()
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
        return best

    out = {"leaf": "4096 x 11008 fp32 (llama-7b w_up)", "cpu": cpu_model(),
           "host_triad_gbps": triad_gbps}
    pn, gn = p.numpy().copy(), gr.numpy()
    ops = ("cpu_adam", "cpu_lion", "cpu_adagrad")
    for name, op, nbytes in zip(ops, (DeepSpeedCPUAdam(lr=1e-4, weight_decay=0.1),
                                      DeepSpeedCPULion(lr=1e-4, weight_decay=0.1),
                                      DeepSpeedCPUAdagrad(lr=1e-4)), (28, 20, 20)):
        ms = best_ms(lambda: op.step(pn, gn, key=0, lr=1e-4))
        out[name] = {"ms": ms, "gbps": nbytes * n / (ms / 1e3) / 1e9, "bytes_per_elem": nbytes}
    m, v = torch.zeros(n), torch.zeros(n)
    step_t = torch.tensor(1.0)
    lib_ms = best_ms(lambda: fused_adamw_library(p, gr, m, v, step_t, 1e-4, 0.1))
    out["cpu_adam"]["library_ms"] = lib_ms
    out["cpu_adam"]["library"] = "torch._fused_adamw_ on CPU tensors"
    rates = {"triad": triad_gbps, "torch._fused_adamw_": 28 * n / (lib_ms / 1e3) / 1e9,
             **{k: out[k]["gbps"] for k in ops}}
    out["bound_by"] = max(rates, key=rates.get)
    out["host_bound_gbps"] = rates[out["bound_by"]]
    for k in ops:
        out[k]["bound_ms"] = out[k]["bytes_per_elem"] * n / (out["host_bound_gbps"] * 1e9) * 1e3
        out[k]["bound_share"] = out[k]["bound_ms"] / out[k]["ms"]
    os.makedirs(NVME_DIR, exist_ok=True)
    h = AsyncIOHandle(thread_count=4)
    mm, vv = np.zeros(n, np.float32), np.zeros(n, np.float32)

    def write():
        h.async_pwrite(mm, os.path.join(NVME_DIR, "m.bin"))
        h.async_pwrite(vv, os.path.join(NVME_DIR, "v.bin"))
        h.drain()

    def read():
        h.async_pread(mm, os.path.join(NVME_DIR, "m.bin"))
        h.async_pread(vv, os.path.join(NVME_DIR, "v.bin"))
        h.drain()

    wms, rms = best_ms(write, 3), best_ms(read, 3)
    out["aio"] = {"backend": h.backend, "write_ms": wms, "read_ms": rms,
                  "write_gbps": 8 * n / (wms / 1e3) / 1e9, "read_gbps": 8 * n / (rms / 1e3) / 1e9,
                  "note": "two moments of the leaf to and from files under build/ (the page "
                          "cache included: the disk alone is not timed)"}
    h.close()
    shutil.rmtree(NVME_DIR, ignore_errors=True)
    print(json.dumps({"host_ops": out}))
    return out


def masters_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.offload_optimizer.master,
                                                     b.offload_optimizer.master))


def offload_1b_phase():
    """Phase 26: llama-1b at full width and depth, 2 steps each: NVMe offload
    bit-equal to cpu offload (losses and masters), SuperOffload with
    cpu_worker_count 4 and 1 bit-equal to plain offload; the host
    optimizer's ms per step for each."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=OFFLOAD_SEQ)
    g = torch.Generator(device=DEV).manual_seed(321)
    batch = torch.randint(0, model.config.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ),
                          generator=g, device=DEV)
    runs = {"cpu": offload_config("cpu"), "nvme": offload_config("nvme", NVME_DIR),
            "super_4": offload_config("cpu", zero_optimization={"offload_optimizer": {
                "device": "cpu", "pin_memory": True, "super_offload": True,
                "cpu_worker_count": 4}}),
            "super_1": offload_config("cpu", zero_optimization={"offload_optimizer": {
                "device": "cpu", "pin_memory": True, "super_offload": True,
                "cpu_worker_count": 1}})}
    ref, out = None, {}
    for name, ds in runs.items():
        e, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, seed=0)
        spans = boundary_timed(e)
        losses = [float(x) for x in timed_steps(e, batch, 2)[0]]
        rec = {"losses": losses, "host_opt_ms": [s["host_opt_ms"] for s in spans],
               "boundary_ms": [s["boundary_ms"] for s in spans],
               "moment_bytes": e.offload_optimizer.moment_bytes()}
        if ref is None:
            ref = (losses, e)
            check(losses[-1] < losses[0], f"offload 1b: loss did not fall: {losses}")
        else:
            check(losses == ref[0], f"offload 1b {name}: losses {losses} != cpu's {ref[0]}")
            check(masters_equal(ref[1], e), f"offload 1b {name}: masters differ from cpu's")
            rec["bit_equal_to_cpu"] = True
            e._apply_step_offload = None
            e.offload_optimizer.close()
            del e
            gc.collect()
        out[name] = rec
    check(out["nvme"]["moment_bytes"] == 0, "offload 1b nvme: moments still in RAM")
    ref[1].offload_optimizer.close()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(NVME_DIR, ignore_errors=True)
    print(json.dumps({"offload_1b": out}))
    return out


def zenflow_phase():
    """Phase 27: ZenFlow on the card.  llama-160m at full width and depth,
    bf16, top 10 % of columns every step and the rest every 2 steps, 4 steps
    on one batch (a slow pass launched at step 2 and merged at step 4): the
    loss falls.  Then at 160m width and 2 layers in fp32,
    ZenFlow with topk_ratio 1.0 against the AdamW offload engine over 3
    steps: losses within 1e-5 relative, masters within 1e-5 absolute (numpy's
    Adam against the C++ op's: one formula, rounded at other points)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("160m", max_seq_len=OFFLOAD_SEQ)
    g = torch.Generator(device=DEV).manual_seed(7)
    batch = torch.randint(0, model.config.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ),
                          generator=g, device=DEV)
    zf = {"enabled": True, "topk_ratio": 0.1, "update_interval": 2}
    e, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=offload_config("cpu", zero_optimization={"zenflow": zf}), seed=0)
    losses, step_ms, _ = timed_steps(e, batch, 4)
    losses = [float(x) for x in losses]
    check(losses[-1] < losses[0], f"zenflow: loss did not fall: {losses}")
    e.offload_optimizer.close()
    del e
    small = llama_model("160m", max_seq_len=256, n_layers=2)
    b2 = batch[:, :, :256]
    fp32 = dict(bf16={"enabled": False}, data_types={"grad_accum_dtype": "fp32"})
    runs = {}
    for name, extra in (("adamw", {}), ("zenflow_topk_1", {"zero_optimization": {
            "zenflow": {"enabled": True, "topk_ratio": 1.0}}})):
        e, *_ = deepspeed_tpu_torch.initialize(model=small,
                                               config=offload_config("cpu", **fp32, **extra),
                                               seed=0)
        runs[name] = ([float(x) for x in timed_steps(e, b2, 3)[0]],
                      [m.copy() for m in e.offload_optimizer.master])
        e.offload_optimizer.close()
        del e
    (la, ma), (lz, mz) = runs["adamw"], runs["zenflow_topk_1"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(la, lz))
    param_diff = max(float(np.abs(a.ravel() - b.ravel()).max()) for a, b in zip(ma, mz))
    check(loss_rel <= 1e-5 and param_diff <= 1e-5,
          f"zenflow topk 1.0 vs adamw: loss rel {loss_rel}, params {param_diff}")
    torch.cuda.empty_cache()
    rec = {"losses": losses, "step_ms": step_ms, "topk_1_vs_adamw": {
        "loss_max_rel": loss_rel, "params_max_abs": param_diff}}
    print(json.dumps({"zenflow": rec}))
    return rec


def offload_param_phase(fadam):
    """Phase 28: offload_param on llama-1b at full width and depth (bf16,
    fused AdamW): 3 steps with the fp32 master in pinned host memory and
    each leaf streamed through kernel C, against the device path: losses
    and masters bit-equal; peak device memory of each; C launches one per
    leaf per step."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=OFFLOAD_SEQ)
    g = torch.Generator(device=DEV).manual_seed(11)
    batch = torch.randint(0, model.config.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ),
                          generator=g, device=DEV)
    out, masters = {}, {}
    for name, extra in (("device", {}), ("offload_param", {"zero_optimization": {
            "stage": 3, "offload_param": {"device": "cpu", "pin_memory": True}}})):
        ds = train_config(**extra)
        ds["train_micro_batch_size_per_gpu"] = OFFLOAD_MICRO
        gc.collect()
        torch.cuda.empty_cache()
        e, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fadam.fused_adam_update.launches = 0
        losses, step_ms, _ = timed_steps(e, batch, 3)
        launches = fadam.fused_adam_update.launches
        out[name] = {"losses": [float(x) for x in losses], "step_ms": step_ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "fused_adam_launches": launches, "leaves": len(e._compute_leaves)}
        check(launches == 3 * len(e._compute_leaves),
              f"{name}: fused_adam launches {launches} != 3 x {len(e._compute_leaves)}")
        masters[name] = [p.detach().cpu() for p in e.get_params().parameters()]
        if name == "offload_param":
            check(all(p.device.type == "cpu" and p.is_pinned() for p in e._master),
                  "offload_param: the master is not in pinned host memory")
        del e
        torch.cuda.empty_cache()
    check(out["device"]["losses"] == out["offload_param"]["losses"],
          f"offload_param: losses differ: {out}")
    check(all(torch.equal(a, b) for a, b in zip(masters["device"], masters["offload_param"])),
          "offload_param: masters differ from the device path's")
    n = sum(t.numel() for t in masters["device"])
    out["peak_saving_gb"] = out["device"]["peak_mem_gb"] - out["offload_param"]["peak_mem_gb"]
    out["master_gb"] = 4 * n / 2**30
    print(json.dumps({"offload_param": out}))
    return out


def hybrid_phase():
    """Phase 29: the hybrid engine on llama-1b with the optimizer offloaded:
    2 steps, then a greedy generate of 16 tokens from the live bf16 leaves
    (no second copy: the inference engine's tensors are the training
    engine's; the device memory before and after is printed), equal to
    init_inference run on get_params() cast to bf16."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=OFFLOAD_SEQ)
    ds = offload_config("cpu", hybrid_engine={"enabled": True, "max_out_tokens": 16})
    e, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, seed=0)
    g = torch.Generator(device=DEV).manual_seed(13)
    batch = torch.randint(0, model.config.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ),
                          generator=g, device=DEV)
    timed_steps(e, batch, 2)
    prompt = torch.randint(0, model.config.vocab_size, (2, 32), generator=g, device=DEV)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    got = e.generate(prompt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    after = torch.cuda.memory_allocated()
    ptrs = {p.data_ptr() for p in e._compute_leaves}
    check({p.data_ptr() for p in e._inference_engine.params.parameters()} == ptrs,
          "hybrid: generation does not read the training engine's leaves")
    ref = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16",
                                                            "max_seq_len": OFFLOAD_SEQ},
                                             params=e.get_params(torch.bfloat16))
    want = ref.generate(prompt, max_new_tokens=16)
    check(got.shape == (2, 48) and torch.equal(got, want),
          "hybrid: generate differs from init_inference on get_params()")
    # offload_states parks the live leaves in host memory and frees the card;
    # reload_states brings back the same weights (the same greedy tokens)
    del ref
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    e.offload_states()
    parked = torch.cuda.memory_allocated()
    check(live - parked >= 0.9 * 2 * sum(p.numel() for p in e._compute_leaves),
          f"hybrid: offload_states freed {(live - parked) / 2**30:.2f} GB only")
    e.reload_states()
    check(torch.equal(e.generate(prompt), want), "hybrid: tokens changed over a park")
    rec = {"generate_s": gen_s, "mem_before_gb": before / 2**30, "mem_after_gb": after / 2**30,
           "mem_delta_gb": (after - before) / 2**30, "tokens": got[:, 32:].tolist(),
           "offload_states_freed_gb": (live - parked) / 2**30}
    e.offload_optimizer.close()
    del e
    torch.cuda.empty_cache()
    print(json.dumps({"hybrid": rec}))
    return rec


#: the optimizers other than Adam.  Through a model, card against CPU, 3
#: fp32 steps at lr 1e-4: a sign-driven step (lion) or Newton-Schulz on a
#: near-zero momentum can move a weight the other way where the two sides'
#: gradients differ in their last digits, up to 2 lr a step (lion: 4e-4
#: after 3 steps, as large as a weight's whole movement), so no element's
#: difference bounds them.  The params are held instead by the L2 norm of
#: the card-minus-CPU difference against the norm of the CPU's movement
#: from the initial weights, over all leaves and in every leaf (a path that
#: applies no update, or skips a leaf, reads 1).  Observed on an H100 over
#: all leaves: lion 7.0e-3 (1650 of 63M elements past ``OPTIMIZER_TOL``'s
#: limit, the flips), lamb 6.6e-5, adagrad 9.6e-5, sgd 9.0e-5, muon
#: 3.0e-4; in one leaf at most 8.3e-3.  Limits: 2e-2 for lion, 1e-3 for the
#: others, 0.1 in a leaf.  The 1-bit family is held by its arithmetic alone:
#: its int8 quantiser turns a last-digit difference of a gradient into a
#: whole quantum, which a frozen variance near 0 then scales up.
OPTIMIZERS = {"lamb": {}, "lion": {}, "adagrad": {}, "sgd": {"momentum": 0.9, "nesterov": True},
              "muon": {}, "onebitadam": {"freeze_step": 2}, "zerooneadam": {
                  "var_freeze_step": 2, "var_update_interval": 2},
              "onebitlamb": {"freeze_step": 2}}
ONEBIT = ("onebitadam", "zerooneadam", "onebitlamb")
for _name in OPTIMIZERS:
    TRAIN_PARITY_TOL[_name] = {"loss": 1e-5, "grad_norm": 1e-4,
                               "params_rel_norm": 2e-2 if _name == "lion" else 1e-3,
                               "params_leaf_rel_norm": 0.1}
#: the optimizers' arithmetic on identical fp32 leaves and gradients, card
#: against CPU, 3 steps at lr 1e-4: the same elementwise ops, powers,
#: square roots, norms and fp32 matmuls (muon; no TF32) in two libraries,
#: a few ulps of each update apart.  (atol, rtol of the leaf's largest
#: movement): an update is a moment over a root, and where the frozen
#: variance is near 0 the 1-bit family moves an element by up to ~1.2 in 3
#: steps, so its last ulps scale with that movement.
OPTIMIZER_TOL = (1e-6, 1e-5)


def optimizers_phase():
    """Phase 30: each of the 8 optimizers' update on the leaves of a 2-layer
    llama-160m-width model (seeded weights, seeded gradients), card against
    CPU, 3 fp32 steps (the 1-bit family crossing its freeze step); then the
    five without a quantiser through that model, card against CPU, 3 fp32
    steps from the same weights and batches."""
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.runtime.lr_schedules import get_schedule
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

    model = llama_model("160m", max_seq_len=128, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(9), "cpu")
    leaves = [p.detach().float() for p in params.parameters()]
    gen = torch.Generator().manual_seed(10)
    grads = [[torch.randn(p.shape, generator=gen) * 1e-2 for p in leaves] for _ in range(3)]
    arith = {}
    for name, extra in OPTIMIZERS.items():
        ps = {}
        for dev in ("cuda", "cpu"):
            tx, _ = build_optimizer(name, {"lr": 1e-4, "weight_decay": 0.1, **extra},
                                    get_schedule(None, {}, 1e-4))
            p = [t.clone().to(dev) for t in leaves]
            st = tx.init(p)
            for g in grads:
                u, st = tx.update([x.to(dev) for x in g], st, p)
                p = [a + b for a, b in zip(p, u)]
            ps[dev] = p
        atol, rtol = OPTIMIZER_TOL
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(ps["cuda"], ps["cpu"]))
        moved = max((b - c).abs().max().item() for b, c in zip(ps["cpu"], leaves))
        within = all((a.cpu() - b).abs().max().item()
                     <= atol + rtol * (b - c).abs().max().item()
                     for a, b, c in zip(ps["cuda"], ps["cpu"], leaves))
        check(within and moved > 0,
              f"optimizer {name}: card vs CPU params differ by {diff} (moved {moved})")
        arith[name] = {"params_max_abs_diff": diff, "moved": moved}
    print(json.dumps({"optimizer_arithmetic": arith}))
    cases = tuple((name, {"optimizer": {"type": name, "params": {
        "lr": 1e-4, "weight_decay": 0.1, **extra}}}, 3, 2, 64)
        for name, extra in OPTIMIZERS.items() if name not in ONEBIT)
    return {"arithmetic": arith,
            "training": train_parity(model, params, cases, "optimizer_parity")}


def cpu_checkpointing_phase():
    """Phase 31: llama-1b at full width and depth, 2 steps through the
    forward / backward / step API: with remat, with remat and
    cpu_checkpointing, and with the offload_dots policy (every residual of a
    block in pinned host memory), bit-equal to each other (losses and
    masters); without remat for scale.  The device memory a forward's graph
    holds until its backward (``forward_graph_gb``: what remat and
    offloading shrink), the peaks of each forward + backward and of the
    whole step (at this size the fp32 optimizer state and the gradients set
    them), and the memory held before each engine (``base_gb``)."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_config, llama_model
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

    g = torch.Generator(device=DEV).manual_seed(17)
    batch = torch.randint(0, llama_config("1b").vocab_size, (OFFLOAD_MICRO, OFFLOAD_SEQ),
                          generator=g, device=DEV)
    out, masters = {}, {}
    try:
        for name, remat, policy, cpu in (("no_remat", False, "nothing_saveable", False),
                                         ("remat", True, "nothing_saveable", False),
                                         ("cpu_checkpointing", True, "nothing_saveable", True),
                                         ("offload_dots", True, "offload_dots", False)):
            model = llama_model("1b", max_seq_len=OFFLOAD_SEQ, remat=remat, remat_policy=policy)
            ds = train_config(activation_checkpointing={"cpu_checkpointing": cpu})
            ds["train_micro_batch_size_per_gpu"] = OFFLOAD_MICRO
            gc.collect()  # the previous engine, if a reference cycle holds it
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated() / 2**30
            e, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, seed=0)
            losses, fb_peak, step_peak, step_ms = [], [], [], []
            for _ in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                losses.append(float(e.forward(batch)))
                fb_peak.append(torch.cuda.max_memory_allocated() / 2**30)
                e.backward()
                e.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                step_peak.append(torch.cuda.max_memory_allocated() / 2**30)
            # what the forward's graph holds on the card until the backward:
            # the residuals remat keeps (block inputs) or offloading moves
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            loss = e.model.loss_fn(e._compute_params(), batch, None)
            torch.cuda.synchronize()
            held = (torch.cuda.memory_allocated() - before) / 2**30
            del loss
            out[name] = {"losses": losses, "step_ms": step_ms, "base_gb": base,
                         "fwd_bwd_peak_gb": fb_peak, "step_peak_gb": step_peak,
                         "forward_graph_gb": held}
            masters[name] = [p.detach().cpu() for p in e._master]
            del e
            torch.cuda.empty_cache()
    finally:
        checkpointing.configure(checkpoint_in_cpu=False)
    for name in ("cpu_checkpointing", "offload_dots"):
        check(out[name]["losses"] == out["remat"]["losses"],
              f"{name}: losses differ from remat's: {out}")
        check(all(torch.equal(a, b) for a, b in zip(masters["remat"], masters[name])),
              f"{name}: masters differ from remat's")
    print(json.dumps({"cpu_checkpointing": out}))
    return out


# -- phases 32-36: the other model families, Hugging Face directories --------

HF_DIR = os.path.join(ROOT, "build", "hf")
#: the shard size of the directories written here (HF's own default is 5 GB)
HF_SHARD_BYTES = 4 << 30
#: the requests of the family serving phases: greedy, 16 to 900 tokens
FAMILY_NEW_TOKENS = 32


def hf_layers(cfg, copies=2):
    """The depth whose bf16 checkpoint fits ``copies`` times in the free
    disk under ``build/`` (the full depth when it fits), and the bytes of
    that checkpoint."""
    from deepspeed_tpu_torch.models.transformer import param_count

    os.makedirs(HF_DIR, exist_ok=True)
    free = shutil.disk_usage(HF_DIR).free
    one = param_count(dataclasses.replace(cfg, n_layers=1))
    per_layer = param_count(dataclasses.replace(cfg, n_layers=2)) - one
    fixed = one - per_layer
    layers = cfg.n_layers
    while layers > 1 and copies * 2 * (fixed + per_layer * layers) > free:
        layers -= 1
    return layers, 2 * (fixed + per_layer * layers), free


def write_hf_dir(name, cfg, model_type, seed=0):
    """Seeded bf16 weights drawn on the card, written by the port's
    ``save_hf_checkpoint`` as a sharded safetensors directory; the card's
    copy is freed.  Returns (path, write seconds, bytes on disk, shards)."""
    from deepspeed_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from deepspeed_tpu_torch.models.transformer import init_transformer_params

    path = os.path.join(HF_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    params = init_transformer_params(cfg, torch.Generator(device=DEV).manual_seed(seed), DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_hf_checkpoint(path, cfg, params, model_type, max_shard_bytes=HF_SHARD_BYTES)
    write_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    files = os.listdir(path)
    size = sum(os.path.getsize(os.path.join(path, f)) for f in files)
    return path, write_s, size, sum(f.endswith(".safetensors") for f in files)


class HostRss:
    """The process's resident set, sampled every 5 ms on a thread while in
    the ``with`` block: ``above_bytes``, its peak above what it was on
    entry (``/proc/self/statm``)."""

    def __enter__(self):
        import threading

        self.base = self.peak = host_rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, host_rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_bytes())
        self.above_bytes = self.peak - self.base
        return False


def host_rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


#: a checkpoint's load may hold at most this many times its bytes in host
#: RAM above what the process held before it: the importer keeps one copy
#: of the weights and one layer more (``checkpoint/hf_import.py``)
HF_LOAD_RSS_LIMIT = 1.25


def check_load_rss(rss, ckpt_bytes, label):
    """The load's host peak within ``HF_LOAD_RSS_LIMIT`` of the checkpoint;
    the reading as a record."""
    share = rss.above_bytes / ckpt_bytes
    check(share <= HF_LOAD_RSS_LIMIT,
          f"{label}: the load held {rss.above_bytes / 1e9:.2f} GB of host RAM for a "
          f"{ckpt_bytes / 1e9:.2f} GB checkpoint ({share:.2f}x > {HF_LOAD_RSS_LIMIT})")
    return {"host_rss_above_gb": rss.above_bytes / 1e9, "host_rss_before_gb": rss.base / 1e9,
            "host_rss_over_ckpt": share}


def check_family_engine(eng, cfg, label):
    """The engine serves the directory's model: its config the written one,
    its weights bf16 on the card."""
    for f in ("hidden_size", "n_layers", "n_heads", "kv_heads", "head_dim", "ffn_size",
              "vocab_size", "position", "norm", "activation", "parallel_block",
              "parallel_norms", "tie_embeddings", "use_bias", "qkv_bias", "rotary_pct"):
        check(getattr(eng.cfg, f) == getattr(cfg, f),
              f"{label}: config {f} {getattr(eng.cfg, f)} != {getattr(cfg, f)}")
    check(eng.device.type == "cuda" and all(
        p.is_cuda and p.dtype == torch.bfloat16 for p in eng.params.parameters()),
        f"{label}: params are not bf16 on cuda")


def drive_family(eng, prompts, fa, pa, label, new_tokens=FAMILY_NEW_TOKENS):
    """``drive`` the greedy requests, then check: every request ran to its
    length, one A launch per layer per prefill call or chunk, one B launch
    per layer per decode body."""
    from deepspeed_tpu_torch.inference.v2 import RaggedRequest

    L = eng.cfg.n_layers
    eng.generate_all([RaggedRequest(prompt_ids=prompts[0][:16], max_new_tokens=9)])  # warm-up
    rec = drive(eng, [RaggedRequest(prompt_ids=p, max_new_tokens=new_tokens)
                      for p in prompts], fa, pa)
    st, la = rec["stats"], rec["launches"]
    calls = st["prefill_calls"] + st["prefill_chunk_calls"]
    check(len(rec["reasons"]) == len(prompts)
          and all(r == "length" for r in rec["reasons"].values())
          and all(len(s) == new_tokens for s in rec["streams"].values()),
          f"{label}: {rec['reasons']}")
    check(calls > 0 and la["flash"] == L * calls,
          f"{label}: flash launches {la['flash']} != {L} layers x {calls} prefill calls")
    check(st["decode_device_steps"] > 0 and la["paged"] == L * st["decode_device_steps"],
          f"{label}: paged launches {la['paged']} != {L} layers x "
          f"{st['decode_device_steps']} decode bodies")
    rec["decode_ms_per_body"] = st["decode_seconds"] / st["decode_device_steps"] * 1e3
    return rec


def falcon_phase(fa, pa):
    """falcon-7b at full width and depth (H 4544, 71 query heads over one KV
    head, D 64, FFN 18176, vocab 65024, 32 layers; bf16, seeded weights)
    written as a sharded HF directory by the port's exporter, then served
    from it: ``InferenceEngineV2.from_pretrained`` with whole-prompt and
    256-token chunked prefill, ``decode_horizon = 8``, 8 greedy requests of
    16 to 900 tokens through 8 slots; then ``init_inference(<dir>)`` ->
    ``generate``.  The depth is cut, and the cut printed, only where the
    free disk holds less than twice the checkpoint."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.families import causal_lm_spec, falcon_config
    from deepspeed_tpu_torch.models.transformer import param_count

    full = falcon_config("7b", dtype=torch.bfloat16)
    layers, ckpt_bytes, free = hf_layers(full)
    cfg = dataclasses.replace(full, n_layers=layers)
    reduced = None if layers == full.n_layers else (
        f"n_layers {full.n_layers} -> {layers}: {free / 1e9:.1f} GB free on disk, "
        f"{2 * ckpt_bytes / 1e9:.1f} GB wanted")
    if reduced:
        print(json.dumps({"falcon_depth_cut": reduced}))
    path, write_s, size, shards = write_hf_dir("falcon-7b", cfg, "falcon")
    rng = torch.Generator().manual_seed(1235)
    lengths = [16, 900] + torch.randint(17, 900, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lengths]
    rec = {"model": "falcon-7b", "layers": layers, "reduced": reduced,
           "params": param_count(cfg), "ckpt_bytes": size, "shards": shards,
           "disk_free_gb": free / 1e9, "write_s": write_s,
           "write_gbps": size / write_s / 1e9}
    torch.cuda.reset_peak_memory_stats()
    params, streams = None, {}
    for mode, chunk in (("whole_prompt", 0), ("chunked_256", 256)):
        rcfg = RaggedInferenceConfig(dtype="bf16", page_size=16, max_seqs=8,
                                     max_pages_per_seq=64, num_pages=576, prefill_chunk=chunk,
                                     decode_horizon=8)
        t0 = time.perf_counter()
        if params is None:
            with HostRss() as rss:
                eng = InferenceEngineV2.from_pretrained(path, rcfg, seed=0)
                torch.cuda.synchronize()
            rec["from_pretrained_s"] = time.perf_counter() - t0
            rec["from_pretrained_host"] = check_load_rss(rss, size, "falcon from_pretrained")
        else:  # the same weights, a second engine
            eng = InferenceEngineV2(causal_lm_spec(eng_cfg), rcfg, params=params, seed=0)
        params, eng_cfg = eng.params, dataclasses.replace(eng.cfg)
        check_family_engine(eng, cfg, f"falcon {mode}")
        r = drive_family(eng, prompts, fa, pa, f"falcon {mode}")
        if not chunk:
            r["decode_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=p[:64], max_new_tokens=64) for p in prompts],
                warm_steps=2, steps=4, groups={"paged": "paged_decode"})
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        streams[mode] = r.pop("streams")
        rec[mode] = {k: v for k, v in r.items() if k != "reasons"}
        print(json.dumps({"falcon_engine": mode, **rec[mode]}))
        eng.close()
        del eng
    # bf16 roundings differ between whole and chunked prefill: reported
    rec["chunked_streams_equal_to_whole"] = sum(
        streams["chunked_256"][u] == s for u, s in streams["whole_prompt"].items())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the dense-cache engine from the same directory: B = 4 prompts of 128
    t0 = time.perf_counter()
    with HostRss() as rss:
        eng = deepspeed_tpu_torch.init_inference(path, config={"dtype": "bf16"})
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_host = check_load_rss(rss, size, "falcon init_inference")
    check(eng.cfg.n_heads == 71 and eng.cfg.kv_heads == 1 and eng.cfg.n_layers == layers,
          f"falcon init_inference: config {eng.cfg}")
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator(device=DEV).manual_seed(43), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(out.shape == (4, 144) and torch.equal(out[:, :128], ids)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"falcon generate: bad stream {tuple(out.shape)}")
    rec["init_inference"] = {"load_s": load_s, **load_host, "generate_s": gen_s,
                             "batch": [4, 128],
                             "new_tokens": 16, "decode_tok_per_s": 4 * 16 / gen_s}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(path, ignore_errors=True)
    print(json.dumps({"falcon": {k: v for k, v in rec.items()
                                 if k not in ("whole_prompt", "chunked_256")}}))
    return rec


#: the serving families at full width, 2 layers each: (config builder's
#: name in models.families, size, HF model_type)
FAMILY_CARD = {"phi-2": ("phi_config", "2", "phi"),
               "gpt-neox-20b": ("gpt_neox_config", "20b", "gpt_neox"),
               "bloom-7b1": ("bloom_config", "7b1", "bloom"),
               "qwen2-7b": ("qwen_config", "7b", "qwen2"),
               "mistral-7b": ("mistral_config", "7b", "mistral"),
               "opt-6.7b": ("opt_config", "6.7b", "opt")}


def families_phase(fa, pa):
    """phi-2 (D 80), gpt-neox-20b (D 96), bloom-7b1 (ALiBi through A and B),
    qwen2-7b, mistral-7b and opt-6.7b at full width and 2 layers (bf16,
    seeded weights): written as HF directories by the port's exporter and
    served by ``InferenceEngineV2.from_pretrained`` (whole-prompt prefill,
    ``decode_horizon = 8``), 4 greedy requests of 16 to 400 tokens; one A
    launch per layer per prefill call, one B per layer per decode body."""
    import gc

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from deepspeed_tpu_torch.models import families

    out = {}
    for name, (builder, size, model_type) in FAMILY_CARD.items():
        cfg = getattr(families, builder)(size, n_layers=2, dtype=torch.bfloat16)
        path, write_s, nbytes, shards = write_hf_dir(name, cfg, model_type)
        rng = torch.Generator().manual_seed(77)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (16, 400, 123, 57)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngineV2.from_pretrained(path, RaggedInferenceConfig(
            dtype="bf16", page_size=16, max_seqs=4, max_pages_per_seq=32, num_pages=128,
            decode_horizon=8), seed=0)
        load_s = time.perf_counter() - t0
        check_family_engine(eng, cfg, name)
        r = drive_family(eng, prompts, fa, pa, name, new_tokens=16)
        out[name] = {"model_type": model_type, "layers": 2, "head_dim": cfg.head_dim,
                     "heads": [cfg.n_heads, cfg.kv_heads], "position": cfg.position,
                     "ckpt_bytes": nbytes, "shards": shards, "write_s": write_s,
                     "from_pretrained_s": load_s, "launches": r["launches"],
                     "ttft_mean_s": r["ttft_mean_s"], "decode_ms_per_body":
                     r["decode_ms_per_body"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        print(json.dumps({"family_engine": name, **out[name]}))
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(path, ignore_errors=True)
    return out


#: the families of phases 32-33 for the card-vs-CPU check (1 layer each)
FAMILY_PARITY = dict(FAMILY_CARD, **{"falcon-7b": ("falcon_config", "7b", "falcon")})


def families_parity_phase():
    """Each serving family at full width and 1 layer in fp32 on the card
    and on the CPU from the same weights: identical greedy streams from
    ``InferenceEngineV2`` and prefill logits within ``PARITY_LOGITS_TOL``."""
    import gc

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_prefill
    from deepspeed_tpu_torch.models import families

    out = {}
    for name, (builder, size, _) in FAMILY_PARITY.items():
        model = families.causal_lm_spec(getattr(families, builder)(size, n_layers=1))
        cfg = model.config
        params = model.init_params(torch.Generator(device=DEV).manual_seed(7), DEV)
        rng = torch.Generator().manual_seed(8)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (7, 40, 23)]
        rcfg = dict(dtype="fp32", page_size=16, max_seqs=4, max_pages_per_seq=8, num_pages=32)
        engines = {dev: InferenceEngineV2(model, RaggedInferenceConfig(**rcfg),
                                          params=params if dev == "cuda" else params.map(
                                              lambda t: t.cpu()), device=dev)
                   for dev in ("cuda", "cpu")}
        streams = {dev: e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8)
                                        for p in prompts]) for dev, e in engines.items()}
        check(streams["cuda"] == streams["cpu"],
              f"{name} parity: greedy streams differ: {streams['cuda']} vs {streams['cpu']}")
        ids = torch.zeros(48, dtype=torch.long)
        ids[:40] = torch.tensor(prompts[1])
        rows = torch.arange(3, dtype=torch.int32)
        logits = {dev: paged_prefill(e.cfg, e.params, e._pools, ids.to(e.device),
                                     rows.to(e.device), 40)[0] for dev, e in engines.items()}
        err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
        check(err <= PARITY_LOGITS_TOL, f"{name} parity: prefill logits max err {err:.3g}")
        out[name] = {"streams_identical": True, "prefill_logits_max_abs_err": err,
                     "logits_max_abs": logits["cpu"].abs().max().item()}
        for e in engines.values():
            e.close()
        del engines, params, logits
        gc.collect()
        torch.cuda.empty_cache()
    out["tol"] = PARITY_LOGITS_TOL
    print(json.dumps({"families_parity": out}))
    return out


def gpt2_train_phase(fa, fadam, steps=8):
    """GPT-2 1.3B (the JAX package's training comparison config #3: 24
    layers, H 2048, 16 heads of 128, learned positions) at full width and
    depth through initialize -> train_batch: bf16, ZeRO stage 2 at one
    rank, fused AdamW, clipping 1.0, seq 1024, micro-batch 4, ``steps``
    steps on one seeded batch (the loss must fall).  Counters zeroed just
    before and read just after: A, A' and A'' on every layer of every step,
    C on every leaf of every step, no host sync inside a step."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_model

    model = gpt2_model("1.3b")
    rec, engine = lm_train_run(
        model, "gpt2-1.3b", train_config(zero_optimization={"stage": 2}),
        lambda g: torch.randint(0, model.config.vocab_size, (1, TRAIN_MICRO, TRAIN_SEQ),
                                generator=g, device=DEV),
        TRAIN_SEQ, TRAIN_MICRO, steps, fa, fadam)
    del engine
    torch.cuda.empty_cache()
    print(json.dumps({"gpt2_train": rec}))
    return rec


def lm_train_run(model, label, ds, make_batch, seq, micro, steps, fa, fadam):
    """``steps`` train_batch calls of ``model`` on one seeded batch, the
    counters zeroed just before and read just after: A, A' and A'' on every
    layer of every step, C on every leaf, the loss falling, no host sync
    inside a step.  Step time, MFU, a profiled step, peak memory.  Returns
    (the record, the engine)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import flops_per_token

    cfg = model.config
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, seed=0)
    init_s = time.perf_counter() - t0
    n_leaves = len(engine._master)
    batch = make_batch(torch.Generator(device=DEV).manual_seed(321))
    zero_train_counters(fa, fadam)
    losses, step_ms, syncs = timed_steps(engine, batch, steps)
    launches = read_train_counters(fa, fadam)
    losses = [float(x) for x in losses]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{label}: the loss did not fall over {steps} steps: {losses}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * steps,
              f"{label}: {k} launches {launches[k]} != {L} layers x {steps} steps")
    check(launches["fused_adam"] == n_leaves * steps,
          f"{label}: fused_adam launches {launches['fused_adam']} != {n_leaves} x {steps}")
    check(syncs == 0, f"{label}: {syncs} host syncs inside train_batch calls")
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = micro * seq
    fpt = flops_per_token(cfg, seq)
    rec = {"model": label, "layers": L, "params": sum(p.numel() for p in engine._master),
           "leaves": n_leaves, "seq": seq, "micro_batch": micro, "dtype": "bf16",
           "zero_stage": ds["zero_optimization"]["stage"], "init_s": init_s,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / (med / 1e3), "flops_per_token": fpt,
           "mfu": fpt * tokens / (med / 1e3) / PEAK_OPS[torch.bfloat16],
           "launches": launches, "host_syncs": syncs,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    rec["profile"] = profile_window(lambda: engine.train_batch(batch), 1, top_n=8,
                                    groups={"flash_bwd_dq": "flash_bwd_dq_wgmma",
                                            "flash_bwd_dkv": "flash_bwd_dkv_wgmma"})
    return rec, engine


BERT_MICRO, BERT_SEQ = 16, 512


def bert_batch(g, vocab, mask=False):
    """A masked-LM batch of BERT-base's shape: 15 % of the positions
    replaced by [MASK] (103) and labelled, the rest labelled -100; two
    segments a sequence; ``mask`` pads each sequence's last 64 positions."""
    ids = torch.randint(0, vocab, (1, BERT_MICRO, BERT_SEQ), generator=g, device=DEV)
    picked = torch.rand(ids.shape, generator=g, device=DEV) < 0.15
    cut = torch.randint(64, BERT_SEQ - 64, (1, BERT_MICRO, 1), generator=g, device=DEV)
    batch = {"input_ids": torch.where(picked, torch.full_like(ids, 103), ids),
             "labels": torch.where(picked, ids, torch.full_like(ids, -100)),
             "token_type_ids": (torch.arange(BERT_SEQ, device=DEV) >= cut).long()}
    if mask:
        am = torch.ones_like(ids)
        am[..., -64:] = 0
        batch["attention_mask"] = am
    return batch


def bert_train_phase(fa, fadam, steps=8):
    """BERT-base MLM pretraining (the JAX package's training comparison
    config #2: 12 layers, H 768, 12 heads, post-norm) at full width and
    depth: bf16, ZeRO 1, fused AdamW, clipping 1.0, seq 512, micro-batch 16,
    ``steps`` steps on one unpadded batch (the non-causal A, A' and A'' on
    every layer of every step, C on every leaf; the loss must fall); then
    one step with an ``attention_mask``, which takes the plain attention
    (no A launch), as both packages do."""
    from deepspeed_tpu_torch.models.bert import bert_model

    model = bert_model("base")
    check(not model.config.causal and model.config.post_norm, "bert: not a post-norm encoder")
    ds = train_config(train_micro_batch_size_per_gpu=BERT_MICRO)
    rec, engine = lm_train_run(model, "bert-base", ds,
                               lambda g: bert_batch(g, model.config.vocab_size),
                               BERT_SEQ, BERT_MICRO, steps, fa, fadam)
    masked = bert_batch(torch.Generator(device=DEV).manual_seed(322), model.config.vocab_size,
                        mask=True)
    zero_train_counters(fa, fadam)
    loss = float(engine.train_batch(masked))
    la = read_train_counters(fa, fadam)
    check(math.isfinite(loss) and la["flash_fwd"] == 0 and la["flash_bwd_dq"] == 0
          and la["fused_adam"] == rec["leaves"],
          f"bert masked step: loss {loss}, launches {la} (the plain attention takes a mask)")
    rec["masked_step"] = {"loss": loss, "launches": la,
                          "note": "an attention_mask takes the plain attention (no A, A', "
                                  "A''), as the JAX package's flash_attention does"}
    del engine
    torch.cuda.empty_cache()
    print(json.dumps({"bert_train": rec}))
    return rec


# -- phase 37: checkpoints and training from an indexed dataset ---------------

CKPT_DIR = os.path.join(ROOT, "build", "ckpt")
#: the resumed runs: (a) llama-1b, steps before and after the save; (b)
#: llama-7b at full width under offload_optimizer cpu, cut to this depth
CKPT_STEPS, CKPT_7B_LAYERS, CKPT_7B_STEPS = 3, 4, 2
#: (b)'s host limits: the save's resident-set rise against the checkpoint's
#: bytes, the load's against its largest stacked [L, ...] member, and the
#: device peak above the allocation before either
CKPT_SAVE_RSS_SHARE, CKPT_LOAD_RSS_MEMBERS, CKPT_DEVICE_SLACK = 0.25, 2.0, 2**30


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def timed_checkpoint(engine, what, fn):
    """``fn()`` timed, with the host resident set's peak rise (``HostRss``)
    and the device's peak above its allocation before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with HostRss() as rss:
        out = fn()
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return out, {f"{what}_s": s, f"{what}_host_rss_above_gb": rss.above_bytes / 1e9,
                 f"{what}_device_peak_above_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}


def resume_case(engine_a, make_engine, save_dir, steps_before, steps_after, step_a, step_b,
                label, after_load=None):
    """Train ``engine_a`` ``steps_before`` steps, save, ``steps_after``
    more (the unbroken run); a fresh engine loads the tag and takes the same
    ``steps_after`` steps.  Losses and the fp32 master must be bit-equal.
    ``step_a(engine, i)`` / ``step_b(engine, i)`` take step ``i``;
    ``after_load(engine, tag_path)`` runs between the load and the steps
    (the fresh engine then holds the tag's state), its result kept."""
    from deepspeed_tpu_torch.resilience import commit

    for i in range(steps_before):
        step_a(engine_a, i)
    path, rec = timed_checkpoint(engine_a, "save", lambda: engine_a.save_checkpoint(
        save_dir, client_state={"steps": steps_before}))
    gb = dir_bytes(path) / 1e9
    rec.update(path=path, ckpt_gb=gb, save_gbps=gb / rec["save_s"])
    la = [float(step_a(engine_a, steps_before + i)) for i in range(steps_after)]
    engine_b = make_engine()
    verify = []
    real = commit.resolve_tag

    def timed_resolve(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        verify.append(time.perf_counter() - t)
        return out

    commit.resolve_tag = timed_resolve
    try:
        (lpath, client), lrec = timed_checkpoint(engine_b, "load",
                                                 lambda: engine_b.load_checkpoint(save_dir))
    finally:
        commit.resolve_tag = real
    check(lpath == path and client == {"steps": steps_before}
          and engine_b.global_steps == steps_before,
          f"{label}: loaded {lpath} {client} at step {engine_b.global_steps}")
    rec.update(lrec, verify_s=verify[0], load_read_s=lrec["load_s"] - verify[0],
               load_gbps=gb / lrec["load_s"],
               load_read_gbps=gb / (lrec["load_s"] - verify[0]))
    if after_load is not None:
        rec["after_load"] = after_load(engine_b, path)
    lb = [float(step_b(engine_b, steps_before + i)) for i in range(steps_after)]
    pa, pb = engine_a.get_params(), engine_b.get_params()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(pa.parameters(), pb.parameters()))
    rec.update(losses_unbroken=la, losses_resumed=lb, master_bit_equal=same)
    check(la == lb, f"{label}: resumed losses {lb} != unbroken {la}")
    check(same, f"{label}: the resumed fp32 master differs from the unbroken run's")
    return rec, engine_b


def checkpoint_phase(fa, fadam):
    """Phase 37.  (a) llama-1b at full width and depth (the train phase's
    config) fed from a Megatron indexed dataset of seeded uint16 tokens
    through ``initialize(training_data=...)`` -> ``train_batch()``:
    CKPT_STEPS steps, save, CKPT_STEPS more; a fresh engine loads the tag
    and takes the same steps on the same batches: losses and fp32 master
    bit-equal.  Save and load seconds and GB/s, the verify seconds, the
    host resident-set and device-peak rises.  (b) llama-7b at full width
    under offload_optimizer cpu, CKPT_7B_LAYERS of 32 layers, the same with
    CKPT_7B_STEPS steps: no state staged on the card (device peak within
    CKPT_DEVICE_SLACK), the host resident set within its limits.  (c) the
    tag of (a) through ``checkpoint_to_hf`` into an HF directory served by
    ``init_inference(<dir>)``: greedy streams equal to ``init_inference``
    on the engine's live params.  Each checkpoint directory is deleted when
    its case ends."""
    import gc

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.hf_export import checkpoint_to_hf
    from deepspeed_tpu_torch.checkpoint.saving import leaf_paths
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    rec = {"disk_free_gb": shutil.disk_usage(CKPT_DIR).free / 1e9,
           "mem_available_gb": meminfo("MemAvailable") / 2**30,
           "host_rss_start_gb": host_rss_bytes() / 1e9}
    # (a) a Megatron dataset of seeded tokens: 64 sequences of seq + 1
    model = llama_model("1b", max_seq_len=TRAIN_SEQ)
    cfg, L = model.config, model.config.n_layers
    rng = np.random.RandomState(2024)
    b = MMapIndexedDatasetBuilder(os.path.join(CKPT_DIR, "corpus"), dtype=np.uint16)
    for _ in range(64):
        b.add_item(rng.randint(0, cfg.vocab_size, TRAIN_SEQ + 1).astype(np.uint16))
        b.end_document()
    data = MMapIndexedDataset(b.finalize())

    def make_1b():
        return deepspeed_tpu_torch.initialize(model=model, config=train_config(), seed=0,
                                              training_data=data)

    engine_a, _, loader_a, _ = make_1b()
    check(loader_a is engine_a.training_dataloader and len(loader_a) == 64 // TRAIN_MICRO,
          f"checkpoint 1b: the dataloader has {len(loader_a)} batches")
    first = next(iter(loader_a))
    check(first.is_cuda and first.dtype == torch.int32 and first.shape == (TRAIN_MICRO,
                                                                          TRAIN_SEQ + 1),
          f"checkpoint 1b: a batch is {first.dtype} {tuple(first.shape)} on {first.device}")
    skip = {}

    def step_b(engine, i):  # the resumed run's loader, past the batches already taken
        if engine not in skip:
            it = iter(engine.training_dataloader)
            for _ in range(i):
                next(it)
            skip[engine] = it
        return engine.train_batch(data_iter=skip[engine])

    def export_and_serve(engine, path):
        """(c): the tag as an HF directory, served, against the fresh
        engine's live params (the tag's state)."""
        hf = os.path.join(CKPT_DIR, "llama1b_hf")
        t0 = time.perf_counter()
        checkpoint_to_hf(os.path.dirname(path), os.path.basename(path), hf, cfg,
                         dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        g = torch.Generator(device=DEV).manual_seed(77)
        prompts = torch.randint(0, cfg.vocab_size, (2, 32), generator=g, device=DEV)
        served = deepspeed_tpu_torch.init_inference(hf, config={"dtype": "bf16"})
        got = served.generate(prompts, max_new_tokens=16)
        del served
        # a bf16 copy: the engine casts a ParamTree it is given in place
        live = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                  params=engine.get_params(torch.bfloat16))
        want = live.generate(prompts, max_new_tokens=16)
        del live
        torch.cuda.synchronize()
        check(got.shape == (2, 48) and torch.equal(got, want),
              "checkpoint_to_hf: the exported directory's greedy streams differ from the "
              "live params'")
        out = {"to_hf_s": export_s, "hf_gb": dir_bytes(hf) / 1e9, "streams_equal": True,
               "prompts": [2, 32], "new_tokens": 16}
        shutil.rmtree(hf, ignore_errors=True)
        return out

    zero_train_counters(fa, fadam)
    a, engine_b = resume_case(
        engine_a, lambda: make_1b()[0], os.path.join(CKPT_DIR, "llama1b"), CKPT_STEPS,
        CKPT_STEPS, lambda e, i: e.train_batch(), step_b, "checkpoint 1b",
        after_load=export_and_serve)
    launches = read_train_counters(fa, fadam)
    n_steps = 3 * CKPT_STEPS
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * n_steps,
              f"checkpoint 1b: {k} launches {launches[k]} != {L} x {n_steps}")
    n_leaves = len(engine_a._master)
    check(launches["fused_adam"] == n_leaves * n_steps,
          f"checkpoint 1b: fused_adam launches {launches['fused_adam']} != "
          f"{n_leaves} x {n_steps}")
    a.update(model="llama-1b", layers=L, params=sum(p.numel() for p in engine_a._master),
             dataset={"sequences": 64, "tokens": TRAIN_SEQ + 1, "dtype": "uint16"},
             launches=launches)
    a["export"] = a.pop("after_load")
    rec["llama1b"] = {k: v for k, v in a.items() if k != "path"}
    print(json.dumps({"checkpoint_1b": rec["llama1b"]}))
    del engine_a, engine_b, loader_a, first, skip
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)

    # (b) llama-7b at full width under offload, the depth cut
    reduced = (f"llama-7b layers 32 -> {CKPT_7B_LAYERS}: full depth holds 81 GB of fp32 "
               f"host state, the disk has {rec['disk_free_gb']:.0f} GB free")
    print(json.dumps({"reduced": reduced}))
    m7 = llama_model("7b", max_seq_len=OFFLOAD_SEQ, n_layers=CKPT_7B_LAYERS)
    g = torch.Generator(device=DEV).manual_seed(321)
    batches = [torch.randint(0, m7.config.vocab_size, (1, OFFLOAD_MICRO, OFFLOAD_SEQ),
                             generator=g, device=DEV) for _ in range(2 * CKPT_7B_STEPS)]

    def make_7b():
        return deepspeed_tpu_torch.initialize(model=m7, config=offload_config("cpu"),
                                              seed=0)[0]

    engine_a = make_7b()
    host = engine_a.offload_optimizer
    zero_train_counters(fa, fadam)
    b7, engine_b = resume_case(engine_a, make_7b, os.path.join(CKPT_DIR, "llama7b"),
                               CKPT_7B_STEPS, CKPT_7B_STEPS,
                               lambda e, i: e.train_batch(batches[i]),
                               lambda e, i: e.train_batch(batches[i]), "checkpoint 7b")
    launches = read_train_counters(fa, fadam)
    n_steps = 3 * CKPT_7B_STEPS
    check(launches["flash_bwd_dkv"] == CKPT_7B_LAYERS * n_steps and launches["fused_adam"] == 0,
          f"checkpoint 7b: launches {launches}")
    member = {}  # the checkpoint's fp32 host members: per-layer leaves stacked
    for (path, _), x in zip(leaf_paths(engine_a._compute), host.master):
        member[path] = member.get(path, 0) + x.nbytes
    largest = max(member.values())
    ckpt_bytes = b7["ckpt_gb"] * 1e9
    b7.update(model="llama-7b", layers=CKPT_7B_LAYERS, reduced=reduced,
              params=sum(p.numel() for p in engine_a._compute_leaves),
              host_state_gb=(host.master_bytes() + host.moment_bytes()) / 1e9,
              largest_member_gb=largest / 1e9, launches=launches,
              save_rss_limit_gb=CKPT_SAVE_RSS_SHARE * ckpt_bytes / 1e9,
              load_rss_limit_gb=CKPT_LOAD_RSS_MEMBERS * largest / 1e9)
    for what in ("save", "load"):
        check(b7[f"{what}_device_peak_above_gb"] <= CKPT_DEVICE_SLACK / 1e9,
              f"checkpoint 7b: the {what} raised the device peak by "
              f"{b7[f'{what}_device_peak_above_gb']:.2f} GB")
    check(b7["save_host_rss_above_gb"] <= b7["save_rss_limit_gb"],
          f"checkpoint 7b: the save held {b7['save_host_rss_above_gb']:.2f} GB of host RAM "
          f"(limit {b7['save_rss_limit_gb']:.2f})")
    check(b7["load_host_rss_above_gb"] <= b7["load_rss_limit_gb"],
          f"checkpoint 7b: the load held {b7['load_host_rss_above_gb']:.2f} GB of host RAM "
          f"(limit {b7['load_rss_limit_gb']:.2f})")
    rec["llama7b_offload"] = {k: v for k, v in b7.items() if k != "path"}
    rec["host_rss_end_gb"] = host_rss_bytes() / 1e9
    print(json.dumps({"checkpoint_7b": rec["llama7b_offload"]}))
    for e in (engine_a, engine_b):
        e.offload_optimizer.close()
    del engine_a, engine_b, host, batches
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(json.dumps({"checkpoint": {k: v for k, v in rec.items()
                                     if k not in ("llama1b", "llama7b_offload")}}))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from deepspeed_tpu_torch.ops import evoformer_attn as ev
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import fused_adam as fadam
        from deepspeed_tpu_torch.ops import grouped_matmul as gm
        from deepspeed_tpu_torch.ops import op_builder
        from deepspeed_tpu_torch.ops import paged_attention as pa
        from deepspeed_tpu_torch.ops import quantization as qz
        from deepspeed_tpu_torch.ops import sparse_attention as sa
        from deepspeed_tpu_torch.ops import wq_matmul as wq
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    global BASE
    register_baselines(op_builder)
    t0 = time.perf_counter()
    secs = op_builder.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel "
          + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    spills = {}
    for name, log in op_builder.build_log.items():
        fn = None
        for line in log["log"].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}")
            if "spill stores" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.setdefault(name, []).append(f"{demangle(fn)}: {line.strip()}")
    # the kernels that spill, by name
    print(json.dumps({"ptxas_spills": spills}))

    BASE = Baseline(op_builder)
    warm_clocks()
    phase_s = {}

    def phase(fn, *args):  # fn(*args), its wall seconds kept under its name
        t = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__] = round(time.perf_counter() - t, 1)
        print(json.dumps({"phase_done": fn.__name__, "seconds": phase_s[fn.__name__]}),
              flush=True)
        return out

    flash = phase(flash_phase, fa)
    paged = phase(paged_phase, pa)
    bwd = phase(flash_bwd_phase, fa)
    adam = phase(adam_phase, fadam)
    wq_recs = phase(wq_phase, wq)
    quant = phase(quant_phase, qz)
    gmm_recs = phase(gmm_phase, gm)
    gmm_bwd = phase(gmm_bwd_phase, gm)
    sparse = phase(sparse_phase, sa)
    evo = phase(evo_phase, ev)
    evo_train = phase(evo_train_phase, ev)

    eng = phase(engine_phase, fa, pa)
    par = phase(parity_phase)
    dpar = phase(decode_parity_phase)
    train = phase(train_phase, fa, fadam)
    tpar = phase(train_parity_phase)
    qeng = phase(quant_engine_phase, fa, pa, wq)
    v1 = phase(inference_v1_phase, qz)
    qpar = phase(quant_parity_phase)
    moe = phase(mixtral_engine_phase, fa, pa, gm)
    mpar = phase(moe_parity_phase)
    moe_train = phase(moe_train_phase, fa, fadam, gm)
    mtpar = phase(moe_train_parity_phase)
    off7 = phase(offload_7b_phase, fa, fadam)
    hops = phase(host_ops_phase)
    # the 7b step's host Adam against the host's memory rate (phase 25's)
    off7["host_bound_gbps"] = hops["host_bound_gbps"]
    off7["host_opt_bound_ms"] = off7["host_opt_bytes"] / (hops["host_bound_gbps"] * 1e9) * 1e3
    off7["host_opt_bound_share"] = off7["host_opt_bound_ms"] / off7["boundary_parts_ms"][
        "host_opt_ms"]
    off1 = phase(offload_1b_phase)
    zen = phase(zenflow_phase)
    oparam = phase(offload_param_phase, fadam)
    hyb = phase(hybrid_phase)
    opars = phase(optimizers_phase)
    ckpt = phase(cpu_checkpointing_phase)
    falcon = phase(falcon_phase, fa, pa)
    fams = phase(families_phase, fa, pa)
    fpar = phase(families_parity_phase)
    gpt2 = phase(gpt2_train_phase, fa, fadam)
    bert = phase(bert_train_phase, fa, fadam)
    ckpt = phase(checkpoint_phase, fa, fadam)
    print(json.dumps({"phase_seconds": phase_s}))

    def timed(recs, keys):
        return {r["case"]: {k: r.get(k) for k in keys} for r in recs if keys[0] in r}

    main_flash = next(r for r in flash if r["case"] == "prefill_s1024")
    main_paged = paged[0]
    main_bwd = bwd[0]
    main_adam = adam[0]
    main_wq = next(r for r in wq_recs if r["case"] == "mlp_up_4096x11008_m8_int8")
    main_q = quant[0]
    q_serving = {m: qeng[m]["launches"] for m in ("int8", "int4")}
    moe_modes = ("whole_prompt", "chunked_256")
    moe_fwd = sum(moe[m]["launches"]["flash"] for m in moe_modes)
    moe_paged = sum(moe[m]["launches"]["paged"] for m in moe_modes)
    moe_gmm = {**{f"moe_serving_{m}": moe[m]["launches"]["grouped_matmul"] for m in moe_modes},
               "moe_generate": moe["generate"]["launches"]["grouped_matmul"]}
    main_gmm = next(r for r in gmm_recs if r["case"] == "decode_up_p1152")
    moe_runs = {k: v["launches"] for k, v in moe_train.items() if k.startswith("run")
                and "launches" in v}
    moe_l = {k: sum(la[k] for la in moe_runs.values()) for k in next(iter(moe_runs.values()))}
    moe_gmm["moe_training"] = moe_l["grouped_matmul"]
    main_bwd_gmm = gmm_bwd[0]
    bwd_gmm_shape = (f"P={main_bwd_gmm['shape'][0]} H=4096 F=14336 E=8 block_rows 128 bf16 "
                     f"(Mixtral-8x7b training, 4096 tokens at top-2, gate/up)")
    serve_fwd = sum(r["launches"]["flash"] for r in eng.values())
    serve_paged = sum(r["launches"]["paged"] for r in eng.values())
    q_fwd = sum(la["flash"] for la in q_serving.values())
    q_paged = sum(la["paged"] for la in q_serving.values())
    codec_l = {k: v1["module_quantize_launches"][k] + v1["lora_launches"][k]
               for k in ("quantize_int8", "dequantize_int8")}
    codec_shape = "n=65,536,000 bf16 (llama-1b embed.tok)"
    train_l = {k: train["launches"][k] + train["gas2"]["launches"][k] + moe_l[k]
               + off7["launches"][k] for k in train["launches"]}
    train_l["fused_adam"] += oparam["offload_param"]["fused_adam_launches"]
    # the family paths (phases 32-36)
    fam_modes = ("whole_prompt", "chunked_256")
    falcon_l = {k: sum(falcon[m]["launches"][k] for m in fam_modes) for k in ("flash", "paged")}
    fams_l = {k: sum(r["launches"][k] for r in fams.values()) for k in ("flash", "paged")}
    lm_train_l = {k: gpt2["launches"][k] + bert["launches"][k] for k in gpt2["launches"]}
    lm_train_l["fused_adam"] += bert["masked_step"]["launches"]["fused_adam"]
    ckpt_l = {k: ckpt["llama1b"]["launches"][k] + ckpt["llama7b_offload"]["launches"][k]
              for k in train_l}
    for k in train_l:
        train_l[k] += lm_train_l[k] + ckpt_l[k]
    bwd_shape = "B=4 S=1024 NH=32 KVH=8 D=64 bf16 causal"
    main_sparse = sparse[0]
    main_evo = evo[0]
    evo_shape = "B=1 S=512 N=384 H=8 D=32 bf16, bias1 and bias2 (AlphaFold 2 MSA row attention)"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:38",
         "launches": serve_fwd + q_fwd + train_l["flash_fwd"] + moe_fwd + falcon_l["flash"]
                     + fams_l["flash"],
         "launches_by_path": {"serving": serve_fwd, "training": train_l["flash_fwd"],
                              "quantized_serving": q_fwd, "moe_serving": moe_fwd,
                              "moe_training": moe_l["flash_fwd"],
                              "offload_training_7b": off7["launches"]["flash_fwd"],
                              "falcon7b_serving": falcon_l["flash"],
                              "families_serving": fams_l["flash"],
                              "gpt2_training": gpt2["launches"]["flash_fwd"],
                              "bert_training": bert["launches"]["flash_fwd"],
                              "checkpoint_training": ckpt_l["flash_fwd"]},
         "max_abs_err": max(r["max_abs_err"] for r in flash), "checked": True,
         "ms": main_flash["ms"], "kernel_ms": main_flash["ms"],
         "plain_ms": main_flash["plain_ms"], "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"], "library_ms": main_flash["library_ms"],
         "previous_ms": main_flash.get("previous_ms"),
         "shape": "B=1 S=1024 NH=32 KVH=8 D=64 bf16 causal",
         "timed_cases": timed(flash, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "previous_ms", "bound_share"))},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:132",
         "launches": train_l["flash_bwd_dq"],
         "launches_by_path": {"offload_training_7b": off7["launches"]["flash_bwd_dq"],
                              "gpt2_training": gpt2["launches"]["flash_bwd_dq"],
                              "bert_training": bert["launches"]["flash_bwd_dq"],
                              "checkpoint_training": ckpt_l["flash_bwd_dq"]},
         "max_abs_err": max(r["dq_max_abs_err"] for r in bwd if "dq_max_abs_err" in r),
         "checked": True,
         "ms": main_bwd["dq_ms"], "plain_ms": main_bwd["plain_ms"],
         "bound_ms": main_bwd["dq_bound_ms"], "bound_by": main_bwd["dq_bound_by"],
         "bound_share": main_bwd["dq_bound_share"], "dq_dkv_ms": main_bwd["dq_dkv_ms"],
         "library_ms": main_bwd["library_ms"], "shape": bwd_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together",
         "timed_cases": timed(bwd, ("dq_ms", "dkv_ms", "dq_dkv_ms", "library_ms", "dq_bound_ms",
                                    "dkv_bound_ms", "dq_bound_share", "dkv_bound_share"))},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:165",
         "launches": train_l["flash_bwd_dkv"],
         "launches_by_path": {"offload_training_7b": off7["launches"]["flash_bwd_dkv"],
                              "gpt2_training": gpt2["launches"]["flash_bwd_dkv"],
                              "bert_training": bert["launches"]["flash_bwd_dkv"],
                              "checkpoint_training": ckpt_l["flash_bwd_dkv"]},
         "max_abs_err": max(max(r["dk_max_abs_err"], r["dv_max_abs_err"]) for r in bwd
                           if "dk_max_abs_err" in r),
         "checked": True, "ms": main_bwd["dkv_ms"], "plain_ms": main_bwd["plain_ms"],
         "bound_ms": main_bwd["dkv_bound_ms"], "bound_by": main_bwd["dkv_bound_by"],
         "bound_share": main_bwd["dkv_bound_share"], "dq_dkv_ms": main_bwd["dq_dkv_ms"],
         "library_ms": main_bwd["library_ms"], "shape": bwd_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:35",
         "launches": serve_paged + q_paged + moe_paged + falcon_l["paged"] + fams_l["paged"],
         "launches_by_path": {"serving": serve_paged, "quantized_serving": q_paged,
                              "moe_serving": moe_paged, "falcon7b_serving": falcon_l["paged"],
                              "families_serving": fams_l["paged"]},
         "max_abs_err": max(r["max_abs_err"] for r in paged), "checked": True,
         "ms": main_paged["ms"], "kernel_ms": main_paged["ms"],
         "plain_ms": main_paged["plain_ms"], "bound_ms": main_paged["bound_ms"],
         "bound_by": main_paged["bound_by"], "library_ms": main_paged["library_ms"],
         "previous_ms": main_paged.get("previous_ms"),
         "bound_share": main_paged.get("bound_share"),
         "decode_step_paged_ms": {
             "llama1b_serving": eng["whole_prompt"]["decode_profile"].get("paged_ms_per_step"),
             "llama7b_int8": qeng["int8"]["decode_profile"].get("paged_ms_per_step"),
             "mixtral_8x7b": moe["whole_prompt"]["decode_profile"].get("paged_ms_per_step")},
         "decode_step_paged_share": {
             "llama1b_serving":
                 eng["whole_prompt"]["decode_profile"].get("paged_share_of_device"),
             "llama7b_int8": qeng["int8"]["decode_profile"].get("paged_share_of_device"),
             "mixtral_8x7b": moe["whole_prompt"]["decode_profile"].get("paged_share_of_device")},
         "shape": "B=8 NH=32 KVH=8 D=64 ps=16 MP=64 bf16",
         "timed_cases": timed(paged, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "previous_ms", "bound_share", "n_split",
                                      "split_sweep_ms"))},
        {"name": "fused_adam", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "deepspeed_tpu/ops/pallas/fused_adam.py:23",
         "launches": train_l["fused_adam"],
         "launches_by_path": {"offload_param": oparam["offload_param"]["fused_adam_launches"],
                              "gpt2_training": gpt2["launches"]["fused_adam"],
                              "bert_training": lm_train_l["fused_adam"]
                              - gpt2["launches"]["fused_adam"],
                              "checkpoint_training": ckpt_l["fused_adam"]},
         "max_abs_err": max(r["max_abs_err"] for r in adam), "checked": True,
         "ms": main_adam["ms"], "plain_ms": main_adam["plain_ms"],
         "bound_ms": main_adam["bound_ms"], "bound_by": main_adam["bound_by"],
         "library_ms": main_adam["library_ms"], "shape": "n=65,536,000 fp32 p/g/m/v",
         "timed_cases": timed(adam, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))},
        {"name": "wq_matmul", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/wq_matmul.cu",
         "replaces": "deepspeed_tpu/ops/pallas/wq_matmul.py:78",
         "launches": sum(la["wq_matmul"] for la in q_serving.values()),
         "launches_by_path": {f"quantized_serving_{m}": la["wq_matmul"]
                              for m, la in q_serving.items()},
         "max_abs_err": max(r["max_abs_err"] for r in wq_recs), "checked": True,
         "ms": main_wq["ms"], "plain_ms": main_wq["plain_ms"], "bound_ms": main_wq["bound_ms"],
         "bound_by": main_wq["bound_by"], "library_ms": None,
         "previous_ms": main_wq.get("previous_ms"), "bound_share": main_wq.get("bound_share"),
         "decode_step_device_ms": {m: qeng[m]["decode_profile"]["device_busy_ms_per_step"]
                                   for m in ("int8", "int4")},
         "decode_step_wq_ms": {m: qeng[m]["decode_profile"].get("wq_ms_per_step")
                               for m in ("int8", "int4")},
         "library_note": "int8: no single PyTorch call (_weight_int8pack_mm scales per "
                         "channel, not per group); int4: library_int4_ms",
         "library_int4_ms": {r["case"]: r.get("library_ms") for r in wq_recs
                             if r["bits"] == 4 and "library_ms" in r and r["group"] == 128},
         "library_int4_error": next((r["library_error"] for r in wq_recs
                                     if "library_error" in r), None),
         "context_cublas_dequantized_ms": main_wq["context_cublas_dequantized_ms"],
         "shape": "M=8 K=4096 N=11008 int8 group 128 bf16 (llama-7b decode, gate/up)",
         "timed_cases": timed(wq_recs, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "context_cublas_dequantized_ms", "previous_ms",
                                        "bound_share"))},
        {"name": "quantize_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/quantization.cu",
         "replaces": "deepspeed_tpu/ops/pallas/quantization.py:20",
         "launches": codec_l["quantize_int8"],
         "launches_by_path": {"module_quantize": v1["module_quantize_launches"]["quantize_int8"],
                              "lora_init": v1["lora_launches"]["quantize_int8"]},
         "max_abs_err": max(r["max_abs_err"] for r in quant), "checked": True,
         "ms": main_q["quant_ms"], "plain_ms": main_q["quant_plain_ms"],
         "bound_ms": main_q["quant_bound_ms"], "bound_by": main_q["quant_bound_by"],
         "library_ms": None, "shape": codec_shape},
        {"name": "dequantize_int8", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/quantization.cu",
         "replaces": "deepspeed_tpu/ops/pallas/quantization.py:29",
         "launches": codec_l["dequantize_int8"],
         "launches_by_path": {"module_quantize":
                              v1["module_quantize_launches"]["dequantize_int8"],
                              "lora_linear": v1["lora_launches"]["dequantize_int8"]},
         "max_abs_err": max(r["max_abs_err"] for r in quant), "checked": True,
         "ms": main_q["dequant_ms"], "plain_ms": main_q["dequant_plain_ms"],
         "bound_ms": main_q["dequant_bound_ms"], "bound_by": main_q["dequant_bound_by"],
         "library_ms": None, "shape": codec_shape},
        {"name": "grouped_matmul", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
         "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:29",
         "launches": sum(moe_gmm.values()), "launches_by_path": moe_gmm,
         "max_abs_err": max(r["max_abs_err"] for r in gmm_recs), "checked": True,
         "ms": main_gmm["ms"], "plain_ms": main_gmm["plain_ms"],
         "bound_ms": main_gmm["bound_ms"], "bound_by": main_gmm["bound_by"],
         "library_ms": main_gmm["library_ms"], "library": main_gmm["library"],
         "context_cublas_dense_ms": main_gmm["context_cublas_dense_ms"],
         "previous_ms": main_gmm.get("previous_ms"),
         "shape": "P=1152 H=4096 F=14336 E=8 block_rows 128 bf16 (Mixtral-8x7b decode, "
                  "8 slots, gate/up)",
         "timed_cases": timed(gmm_recs, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "context_cublas_dense_ms", "previous_ms",
                                         "bound_share"))},
        *({"name": f"grouped_matmul_{w}", "route": "cuda",
           "source": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
           "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:38",
           "note": f"G{mark}: the backward ({w}) of grouped_matmul, which the JAX package "
                   "differentiates by XLA autodiff of its einsum branch (:49-53); no Pallas "
                   "kernel of its own",
           "launches": moe_l[f"grouped_matmul_{w}"],
           "launches_by_path": {"moe_training": moe_l[f"grouped_matmul_{w}"]},
           "launches_per_step": {k: moe_train[k]["launches_per_step"][f"grouped_matmul_{w}"]
                                 for k in moe_runs},
           "max_abs_err": max(r[f"{w}_max_abs_err"] for r in gmm_bwd), "checked": True,
           "ms": main_bwd_gmm[f"{w}_ms"], "plain_ms": main_bwd_gmm[f"{w}_plain_ms"],
           "bound_ms": main_bwd_gmm[f"{w}_bound_ms"],
           "bound_by": main_bwd_gmm[f"{w}_bound_by"],
           "bound_share": main_bwd_gmm[f"{w}_bound_share"],
           "library_ms": main_bwd_gmm[f"{w}_library_ms"], "library": "torch._grouped_mm",
           "previous_ms": main_bwd_gmm.get(f"{w}_previous_ms"),
           "shape": bwd_gmm_shape,
           "timed_cases": timed(gmm_bwd, (f"{w}_ms", f"{w}_plain_ms", f"{w}_bound_ms",
                                          f"{w}_bound_by", f"{w}_library_ms",
                                          f"{w}_bound_share", f"{w}_previous_ms"))}
          for w, mark in (("dx", "'"), ("dw", "''"))),
        {"name": "sparse_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/sparse_attention.py:128",
         "launches": main_sparse["path_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in sparse), "checked": True,
         "ms": main_sparse["ms"], "plain_ms": main_sparse["plain_ms"],
         "bound_ms": main_sparse["bound_ms"], "bound_by": main_sparse["bound_by"],
         "library_ms": main_sparse["library_ms"],
         "library_note": "SDPA with the layout expanded to a boolean mask",
         "previous_ms": main_sparse.get("previous_ms"),
         "bound_share": main_sparse.get("bound_share"),
         "path_kernels": main_sparse["path_kernels"],
         "shape": "B=1 S=4096 H=16 D=64 bf16 block 128, Fixed (4 local, 1 global), causal",
         "timed_cases": timed(sparse, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "previous_ms", "bound_share"))},
        {"name": "evoformer_attn_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/evoformer_attn.cu",
         "replaces": "deepspeed_tpu/ops/pallas/evoformer_attn.py:48",
         "launches": evo_train["launches"]["evoformer_attn_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in evo), "checked": True,
         "ms": main_evo["fwd_ms"], "plain_ms": main_evo["fwd_plain_ms"],
         "bound_ms": main_evo["fwd_bound_ms"], "bound_by": main_evo["fwd_bound_by"],
         "library_ms": main_evo["library_fwd_ms"],
         "library_note": "SDPA with bias1 + bias2 summed into a float attn_mask",
         "previous_ms": main_evo.get("previous_fwd_ms"),
         "bound_share": main_evo.get("fwd_bound_share"),
         "shape": evo_shape, "timed_cases": timed(evo, ("fwd_ms", "fwd_plain_ms",
                                                        "fwd_bound_ms", "library_fwd_ms",
                                                        "previous_fwd_ms",
                                                        "fwd_bound_share"))},
        {"name": "evoformer_attn_bwd_dq", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/evoformer_attn.cu",
         "replaces": "deepspeed_tpu/ops/pallas/evoformer_attn.py:145",
         "launches": evo_train["launches"]["evoformer_attn_bwd_dq"],
         "max_abs_err": max(max(r["dq_max_abs_err"], r.get("db1_max_abs_err", 0.0))
                            for r in evo if r["masked_row"] is None), "checked": True,
         "ms": main_evo["dq_ms"], "plain_ms": main_evo["bwd_plain_ms"],
         "bound_ms": main_evo["dq_bound_ms"], "bound_by": main_evo["dq_bound_by"],
         "library_ms": main_evo["library_bwd_bias_ms"],
         "previous_ms": main_evo.get("previous_dq_ms"),
         "bound_share": main_evo.get("dq_bound_share"),
         "dq_dkv_ms": main_evo["dq_dkv_ms"], "dq_dkv_vs_library": main_evo["dq_dkv_vs_library"],
         "plan": main_evo["dq_plan"],
         "library_no_bias_grad_ms": main_evo["library_bwd_ms"], "shape": evo_shape,
         "note": "plain_ms and library_ms compute the whole backward; library_ms: SDPA's "
                 "backward with the float mask requiring grad, plus the two sums that "
                 "reduce its gradient to dbias1 and dbias2 (library_no_bias_grad_ms: "
                 "without the mask's gradient)",
         "timed_cases": timed(evo, ("dq_ms", "bwd_plain_ms", "dq_bound_ms",
                                    "library_bwd_ms", "library_bwd_bias_ms", "previous_dq_ms",
                                    "dq_bound_share", "dq_dkv_ms", "dq_dkv_vs_library"))},
        {"name": "evoformer_attn_bwd_dkv", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/evoformer_attn.cu",
         "replaces": "deepspeed_tpu/ops/pallas/evoformer_attn.py:196",
         "launches": evo_train["launches"]["evoformer_attn_bwd_dkv"],
         "max_abs_err": max(max(r["dk_max_abs_err"], r["dv_max_abs_err"],
                                r.get("db2_max_abs_err", 0.0))
                            for r in evo if r["masked_row"] is None), "checked": True,
         "ms": main_evo["dkv_ms"], "plain_ms": main_evo["bwd_plain_ms"],
         "bound_ms": main_evo["dkv_bound_ms"], "bound_by": main_evo["dkv_bound_by"],
         "library_ms": main_evo["library_bwd_bias_ms"],
         "previous_ms": main_evo.get("previous_dkv_ms"),
         "bound_share": main_evo.get("dkv_bound_share"),
         "library_no_bias_grad_ms": main_evo["library_bwd_ms"], "shape": evo_shape,
         "note": "plain_ms and library_ms compute the whole backward; library_ms: SDPA's "
                 "backward with the float mask requiring grad, plus the two sums that "
                 "reduce its gradient to dbias1 and dbias2 (library_no_bias_grad_ms: "
                 "without the mask's gradient)",
         "timed_cases": timed(evo, ("dkv_ms", "bwd_plain_ms", "dkv_bound_ms",
                                    "library_bwd_ms", "library_bwd_bias_ms",
                                    "previous_dkv_ms", "dkv_bound_share"))},
    ]
    check(len(kernels) == 15 and all(k["launches"] > 0 for k in kernels),
          "a kernel of the path never launched")
    print(json.dumps({"engine_summary": {m: {k: r.get(k) for k in (
        "ttft_mean_s", "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s",
        "mean_step_ms", "steps", "wall_s", "launches", "decode_tokens_per_host_sync",
        "decode_tokens_per_invocation", "spec_acceptance_rate", "peak_mem_gb",
        "streams_equal_to_whole_prompt")} for m, r in eng.items()},
        "decode_profiles": {m: r["decode_profile"] for m, r in eng.items()
                            if "decode_profile" in r},
        "prefill_profile": eng["whole_prompt"]["prefill_profile"],
        "horizon_8_replay_b_launches": eng["horizon_8"]["replay_b_launches"],
        "card": smi, "parity": par, "decode_parity": dpar}))
    print(json.dumps({"train_summary": {k: train[k] for k in (
        "median_step_ms", "tokens_per_s", "mfu", "peak_mem_gb", "losses", "launches")},
        "train_profile": train["profile"], "gas2": train["gas2"],
        "train_parity": {n: {"steps": r["steps"], "params_max_abs_diff": r["params_max_abs_diff"]}
                         for n, r in tpar.items()}}))
    print(json.dumps({"quant_summary": {m: {k: r[k] for k in (
        "param_bytes", "cosine_vs_bf16", "cosine_vs_fp32", "peak_mem_gb", "ttft_mean_s",
        "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s", "mean_step_ms",
        "launches", "decode_profile")} for m, r in qeng.items() if m in ("int8", "int4")},
        "bf16": qeng["bf16"], "cosine_2_layers": qeng["cosine_2_layers"],
        "inference_v1": v1, "quant_parity": qpar}))
    print(json.dumps({"moe_summary": {m: {k: moe[m][k] for k in (
        "ttft_mean_s", "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s",
        "mean_step_ms", "steps", "wall_s", "launches", "param_bytes", "peak_mem_gb")}
        for m in moe_modes},
        "decode_profile": moe["whole_prompt"]["decode_profile"],
        "prefill_profile": moe["whole_prompt"]["prefill_profile"],
        "generate": moe["generate"], "params": moe["params"], "peak_mem_gb": moe["peak_mem_gb"],
        "moe_parity": mpar}))
    print(json.dumps({"moe_train_summary": {
        k: {f: v.get(f) for f in ("model", "layers", "remat", "params", "losses",
                                  "median_step_ms", "tokens_per_s", "mfu", "peak_mem_gb",
                                  "launches_per_step", "host_syncs")}
        for k, v in moe_train.items() if k in moe_runs},
        "run1_profile": moe_train["run1"]["profile"],
        "run2_bit_equal": moe_train["run2_bit_equal"], "moe_train_parity": mtpar,
        "gmm_bwd": {r["case"]: {k: r.get(k) for k in ("dx_max_abs_err", "dw_max_abs_err",
                                                       "dx_ms", "dw_ms", "dx_previous_ms",
                                                       "dw_previous_ms")} for r in gmm_bwd},
        "card": smi}))
    print(json.dumps({"evo_summary": {"train": evo_train, "cases": {r["case"]: {
        k: r[k] for k in ("max_abs_err", "bwd_max_abs_err") if k in r} for r in evo}},
        "sparse_summary": {r["case"]: r["max_abs_err"] for r in sparse}}))
    print(json.dumps({"offload_summary": {
        "llama7b": {k: off7[k] for k in (
            "mode", "layers", "reduced", "params", "median_step_ms", "fwd_bwd_ms",
            "boundary_parts_ms", "host_opt_gbps", "host_triad_gbps", "host_bound_gbps",
            "host_opt_bound_ms", "host_opt_bound_share",
            "tokens_per_s", "mfu", "peak_mem_gb", "peak_above_base_gb", "base_gb",
            "resident_after_init_gb", "master_bytes",
            "moment_bytes", "pinned_bytes", "rss_gb", "losses", "init_s", "cpu")},
        "host_ops": hops, "llama1b": off1, "zenflow": zen, "offload_param": oparam,
        "hybrid": hyb, "optimizer_arithmetic": opars["arithmetic"],
        "optimizer_parity": {n: {k: r[k] for k in (
            "steps", "params_max_abs_diff", "params_rel_norm", "params_leaf_rel_norm",
            "params_past_tight", "params_past_tight_share")}
            for n, r in opars["training"].items()},
        "cpu_checkpointing": ckpt, "card": smi}}))
    print(json.dumps({"families_summary": {
        "falcon7b": {k: falcon[k] for k in (
            "layers", "reduced", "params", "ckpt_bytes", "shards", "write_s", "write_gbps",
            "from_pretrained_s", "from_pretrained_host", "init_inference", "peak_mem_gb",
            "chunked_streams_equal_to_whole")},
        "falcon7b_serving": {m: {k: falcon[m].get(k) for k in (
            "ttft_mean_s", "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s",
            "decode_ms_per_body", "mean_step_ms", "launches", "peak_mem_gb", "decode_profile")}
            for m in fam_modes},
        "serving_2_layers": fams, "card_vs_cpu": fpar,
        "training": {r["model"]: {k: r[k] for k in (
            "median_step_ms", "tokens_per_s", "mfu", "peak_mem_gb", "losses", "launches",
            "profile")} for r in (gpt2, bert)},
        "bert_masked_step": bert["masked_step"], "card": smi}}))
    print(json.dumps({"checkpoint_summary": {
        "llama1b": {k: ckpt["llama1b"][k] for k in (
            "ckpt_gb", "save_s", "save_gbps", "verify_s", "load_s", "load_gbps",
            "load_read_gbps", "save_host_rss_above_gb", "load_host_rss_above_gb",
            "save_device_peak_above_gb", "load_device_peak_above_gb", "master_bit_equal")},
        "llama7b_offload": {k: ckpt["llama7b_offload"][k] for k in (
            "ckpt_gb", "save_s", "save_gbps", "verify_s", "load_s", "load_gbps",
            "load_read_gbps", "save_host_rss_above_gb", "save_rss_limit_gb",
            "load_host_rss_above_gb", "load_rss_limit_gb", "save_device_peak_above_gb",
            "load_device_peak_above_gb", "master_bit_equal", "reduced")},
        "disk_free_gb": ckpt["disk_free_gb"], "mem_available_gb": ckpt["mem_available_gb"],
        "host_rss_start_gb": ckpt["host_rss_start_gb"], "card": smi}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
