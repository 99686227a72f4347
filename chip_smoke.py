"""Drive the PyTorch + CUDA port (``vit_tpu_torch``) once on one NVIDIA card
and check it:  ``python3 chip_smoke.py``

Phases (a failed phase raises; nothing is caught):
  1. require a card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``vit_tpu_torch/csrc``;
  3. each kernel (K1 ln_qkv_attn, K2 out_ln_mlp_residual, K3 layer_norm)
     against its plain PyTorch twin on the card, bf16 and fp32, at ViT-B/16
     shapes for batch 100 and a ragged batch of 3, with both timed (K3 also
     as profiler device time, beside ``F.layer_norm``'s: its wrapper's host
     cost dominates an events reading); and the bf16 GEMM core of K1, K2, K4-K12c, K16 and K22
     (``csrc/gemm_mma.cuh``)
     alone at the main path's four GEMM shapes (M 19,700) and at the four products
     of the MLP backward at @512 batch 16 (16,400 rows: dY W2ᵀ and du W1ᵀ
     with the weight read K-major, the weight gradients h2ᵀ du and gᵀ dY
     with the activation read MN-major and the rows split), against fp32
     ``torch.matmul`` of the same bf16 operands, timed beside one bf16
     ``torch.matmul`` on them; and the two MLP weight gradients and dW_o
     (768 x 768) at 16,400 and 10,944 (64 x 171) rows, and dW_o at 12,608
     (64 x 197), timed at several split counts of their depth beside the
     kernels' own rule, with the count the rule picks;
  4. the classify CLI in-process on synthetic B/16 reference weights:
     ``--synth 100 --ops fused --dtype bfloat16 --device cuda``, with every
     launch count set to 0 just before and read just after (12 K1, 12 K2,
     1 K3 per forward);
  5. correctness at full width: fp32 fused vs fp32 eager on the card
     (8 images), vs the eager path in float64 on the CPU (2 images), and
     bf16 fused vs fp32 fused over the batch of 100 (decisive labels, top
     probability);
  6. images/s at batch 100 bf16, fused and eager, timed in turns, and a
     torch.profiler trace of one fused forward: device time by kernel and
     the device's busy share of the forward's wall time;
  7. the training kernels (K4 out_residual, K5 ln_mlp_residual, K6
     ln_qkv_attn_bwd, K7 ln_mlp_out_residual_bwd) against their plain
     twins, every output (dx, dctx, each weight and bias gradient), bf16 and
     fp32, at B/16 shapes for batch 64 and 3, with both timed and each line
     with its share of its bound, and K5 also with ``return_u`` (the
     pre-GELU stash beside out); the bf16 K7's MLP outputs equal to K8's
     bit for bit at batch 64 (one chain); K9 on K7's own bf16 dx1 giving
     K7's dctx and dW_o bit for bit (one out_proj tail), and two runs of
     K9 the same bits; and the bf16 K5, K11, K6, K4 and K10 split
     by CUDA kernel in a profiler trace (batch 64: K5's LN2 rows, FC1 and
     FC2, K11 likewise at dropout and drop-path 0.1; K6 plain at T 197 and
     with token merging's bias at T 171; K4 and K10, one GEMM on the TMA +
     ``wgmma`` core each, at batch 64 T 197, @512 batch 16 and batch 100 T
     158, K10 at dropout and drop-path 0.1);
  8. the train CLI in-process: ``--config vit_b_16 --steps 5 --batch 64
     --ops fused_train --mixed-precision --device cuda``, with every launch
     count set to 0 just before and read just after (12 each of K1, K4, K5,
     K6, K7 per step; no K2 or K3);
  9. training correctness at full width: fused_train vs eager autograd
     gradients for every leaf (fp32, 4 images), bf16 mixed vs fp32 loss, and
     memorization of 32 images through the trainer's step;
 10. train images/s at batch 64 mixed precision, fused_train and eager,
     timed in turns, with the peak device memory of each;
 11. the regularized kernels (K10 out_residual_train, K11
     ln_mlp_residual_train, K12a ln_mlp_out_residual_bwd_train) against
     their plain twins at dropout 0.1 and drop-path 0.1, every output, bf16
     and fp32, batch 64 and 3, timed beside K4, K5 and K7, each line with
     its share of its bound; K10's exact zeros
     against the twin's (the mask pattern); K10/K11/K12a/K12c at zero rates
     bit for bit equal to K4/K5/K7/K9; the kept fraction of each dropout site, read
     off the kernels' outputs, within 4 sigma of 1 - p;
 12. the train CLI with ``--dropout 0.1 --drop-path 0.1`` (otherwise as in
     8), with the counts set to 0 just before and read just after (12 each
     of K1, K10, K11, K12a, K6 per step; none of K2-K5, K7);
 13. regularized training correctness at full width: fp32 fused_train
     gradients against autograd through the regularized block's plain twin
     (``train_block_reference_2d``) under the same seeds, every leaf, 4
     images; bf16 mixed vs fp32 loss;
 14. train images/s at batch 64 mixed precision, timed in turns:
     regularized fused_train, unregularized fused_train, regularized eager,
     with the peak device memory of each (no mask is stored, so the
     regularized step's peak is within 1% of the unregularized one's);
 15. the long-sequence kernels (K13 flash_attention_fwd, K14
     flash_attention_bwd, K8 ln_mlp_residual_bwd, K9 out_residual_bwd)
     against their plain twins, every output, bf16 and fp32, at ViT-B/16
     @512 shapes (T = 1,025; batch 16, and a ragged batch of 3), K13/K14
     also at T = 2,048 batch 4; K13/K14 through strided views of the
     packed QKV, as the path calls them, each timed beside
     ``F.scaled_dot_product_attention`` (its forward for K13, its backward
     as forward + backward less forward for K14), each with its share of
     its bound and its TFLOP/s; the bf16 K13 (on ``mma.sync`` register
     tiles) at T 1, 15, 16, 17, 63, 64, 65, 197, 1,025 and 2,048 at every
     head width, out and lse; and the bf16 K9 split by CUDA kernel (@512
     batch 16 and batch 64 at T 171: the column sum, the dctx GEMM, the
     split weight gradient and its partial sum) and K12c at batch 64 T 171,
     dropout and drop-path 0.1 (its gate rows first);
 16. the long classify path: ``InferenceEngine`` at B/16 @512, batch 16,
     bf16, ``fused``, with every count set to 0 just before and read just
     after (13 K3, 12 K13, 12 K2, no K1 per forward); fp32 fused vs fp32
     eager (4 images, <= 1e-3) and bf16 vs fp32 (comparator rule);
 17. the long train path: the trainer's step at @512 batch 16, bf16 mixed,
     ``fused_train``, counts set to 0 just before and read just after (12
     each of K13, K14, K4, K5, K8, K9 per step; no K1, K6, K7); fp32
     fused_train vs eager autograd gradients on every leaf (2 images), bf16
     mixed vs fp32 loss;
 18. images/s and peak device memory of the long classify forward and the
     long train step, fused against eager, timed in turns;
 19. where the 1,024-token switch sits: the K1 + K2 block against the
     K3 + QKV GEMM + K13 + K2 block at T = 577 and T = 1,025 (batch 16,
     bf16), timed in turns;
 20. the W8A8 kernels (K15 ln_qkv_attn_q8, K16 out_ln_mlp_residual_q8, K17
     ln_mlp_residual_q8) against their plain twins, bf16 and fp32, at B/16
     shapes for batch 100 and a ragged batch of 3, and K15's stages 1-2
     (ln_qkv_q8, the long block's int8 QKV stage) at @512 shapes, batch 16
     and 3, all timed.  Each by two checks (``vit_tpu_torch/eval/
     quant_stages.py`` derives the bounds): (a) every row quantizer's codes
     and scales against the twin's quantizer on the kernel's own input
     stage — each code within 1, at most 1e-3 of them different, scales
     within 2^-20; bit for bit where the input is the fp32 ``mid`` scratch;
     (b) every other stage against the twin's stage run on the kernel's own
     codes and scales, at the tolerance above; and the output against the
     whole twin's within 2^-6 (a few moved codes).  The bf16 K15, K16 and
     K17 split by CUDA kernel at batch 100.  The two int8 GEMM cores alone
     (the TMA + ``wgmma`` core of the bf16 K15-K17, the WMMA core of the
     others), each exact, timed at the three GEMM shapes beside
     ``torch._int_mm``;
 21. the classify CLI with ``--ops quant`` (otherwise as in 4), counts set to
     0 just before and read just after (12 K15, 12 K16, 1 K3; none of K1,
     K2, K13, K17);
 22. W8A8 correctness at full width: bf16 ``quant`` vs fp32 ``fused`` over
     the batch of 100 by the comparator rule (the quant path's contract is
     that labels survive), and fp32 ``quant`` on the card vs the same model
     through the quant kernels' plain twins (8 images).  Twelve layers of
     quantizers amplify every moved code, so the logits are held to the
     comparator rule and to moving less than int8 itself moves them
     against fp32 ``fused``; the kernels are held tightly in phase 20;
 23. the long W8A8 path: ``InferenceEngine`` at B/16 @512, batch 16, bf16,
     ``quant``, counts set to 0 just before and read just after (12 of the
     int8 QKV stage, 12 K13, 12 K16, 1 K3 — LN1 lives inside the QKV stage;
     none of K1, K2, K15); bf16 vs fp32 ``quant`` by the comparator rule;
 24. images/s and peak device memory of ``quant``, ``fused`` and ``eager``,
     bf16, at @224 batch 100 and @512 batch 16, timed in turns.

 25. token merging's kernels at B/16 width on merged token counts (ToMe r =
     13): K1 with the log-size bias and the k-mean (batch 100 at T 158 and
     3 at T 41), K6 with the bias and without the residual join, K12b
     ln_mlp_residual_bwd_train and K12c out_residual_bwd_train (batch 64 at
     T 171 and 3 at T 41; dropout and drop-path 0.1) and K8
     ln_mlp_residual_bwd (the plain ToMe step's, at the same counts), each
     against its twin, bf16 and fp32, timed; K15 with both hooks by the
     W8A8 stage checks (its k-mean bit for bit the mean key of its own
     dequantized QKV);
 26. head width 80 at a ViT-H/14-like shape (D 1,280, 16 heads, T 257,
     batch 8): K1, K6, K13, K14 against their twins and K15 by the stage
     checks;
 27. the classify CLI with ``--tome 13`` on ``fused`` (12 K1, 12 K4, 12 K5;
     no K2, K3) and on ``quant`` (12 K15, 12 K4, 12 K17), counts set to 0
     just before and read just after;
 28. the train CLI with ``--tome 13`` (otherwise as in 8, at AdamW 1e-4),
     plain (12 each of K1, K4, K5, K6, K9, K8 per step) and with
     ``--dropout 0.1 --drop-path 0.1`` (12 each of K1, K10, K11, K6, K12c,
     K12b), each loss falling over its steps;
 29. ToMe correctness at full width: fp32 ``fused`` against ``forward_eager``
     on the kernel's own matching (``vit_tpu_torch/eval/tome_stages.py``:
     each merge's k-mean within 2^-16, logits within 1e-3); bf16 ``fused``
     and ``quant`` against fp32 ``fused`` ToMe by the comparator rule; fp32
     ``fused_train`` ToMe gradients against eager autograd on the kernel's
     own matching, every leaf, plain and regularized;
 30. ToMe img/s of ``fused`` and ``quant`` at r = 0, 13, 16 (batch 100
     bf16), one r = 13 forward of each in a profiler trace (device time by
     kernel, busy share), and the train step at r = 0 and 13 (batch 64
     bf16 mixed, plain and regularized), timed in turns.

 31. the per-op kernels (K21 scaled_dot_product_attention on strided views
     of a packed QKV, as the per-op attention calls it; K22 mlp) against
     their plain twins, bf16 and fp32, at B/16 shapes for batch 100 and a
     ragged batch of 3, K21 also at phase 26's head width 80, at @384 (T
     577, batch 32) and at T 1,024 (batch 8, the switch to K13), all timed,
     K21 beside ``F.scaled_dot_product_attention`` on the same q, k, v;
     the bf16 K22 split by CUDA kernel at batch 100;
 32. the classify CLI with ``--ops per_op`` (25 K3, 12 K21, 12 K22; none of
     K1, K2, K13), counts set to 0 just before and read just after; then
     ``--profile`` on ``per_op`` and on ``fused``: its six phase lines
     print, and K21/K22 run 12 x 3 more times in the profile;
 33. per-op correctness and speed: fp32 ``per_op`` vs fp32 ``eager`` (8
     images, <= 1e-3), bf16 ``per_op`` vs fp32 ``fused`` by the comparator
     rule; ``per_op`` at @512 batch 16 (12 K13, no K21); img/s of
     ``per_op``, ``fused`` and ``eager`` at batch 100 bf16, in turns;
 34. K20 (the fused AdamW) against its twin on every leaf of B/16's fp32
     params, and on one bf16 leaf, over 3 steps: p, mu and nu within 2^-20
     of each leaf's largest |value| (a bf16 p within one rounding); one
     launch for a step over the 20 leaves, its time in turns with
     ``torch.optim.AdamW``'s fused step (CUDA events, and device time in a
     profiler trace), and beside its foreach step, on the same tensors;
 35. the train CLI with ``--optimizer fused_adamw`` (otherwise as in 8, at
     AdamW 1e-4): 1 K20 per step beside 12 each of K1, K4-K7, a loss that
     falls; then the train step's img/s with ``fused_adamw`` against
     ``adamw``, in turns.

 36. tensor parallelism's kernels at rank 0's shard of B/16 for tp = 2 and 4
     (F/tp hidden columns, 12/tp heads), batch 100 and 3, bf16 and fp32,
     each against its twin and timed: K5's partial form, K1 and K15 over
     the shard's local heads, K18a ln_fc1_gelu_q8 and K18b fc2_q8_partial
     (by the W8A8 stage checks; K18b's codes and int32 sums bit for bit);
     then K18 composed over 2 and 4 shards in one process (K18a per shard,
     the row maxima's maximum, K18b per shard, the int32 sum, the dequant)
     against K17 on the same x: mid, the row scales, the codes and the
     int32 sums bit for bit, the output within one rounding; then the
     bf16 K18a and K18b split by CUDA kernel at batch 100 for tp 2 and 4;
 37. the kernel study: K19 ln_qkv_attn_q8a with int8 p·v and with p·v in
     the dtype, beside K15, at batch 100 and 3 bf16, by the stage checks
     (the q, k, v and p codes within 1 on the kernel's own packed QKV and
     scores; the context against the twin's on the kernel's codes), timed;
     the bf16 K19 in both forms split by CUDA kernel at batch 100; then ``python3 -m vit_tpu_torch.cli.bench_kernels --batch 100`` over
     its eight kernels (12 launches per stack of layers, 13 stacks each);
 38. two ranks sharing the card over gloo, started by ``torchrun`` with a
     time limit (``--rank-worker``): the classify CLI with ``--ops quant
     --tp 2`` (12 K15, 12 K18a, 12 K18b, 1 K3 per rank), ``--ops fused --tp
     2`` (12 K1, 12 K5 partial, 1 K3) and ``--ops fused --dp 2`` (12 K1 and
     12 K2 on 50 images each), counts set to 0 just before and read just
     after on every rank; their result lines against the single-card CLI's
     by the comparator rule; fp32 ``fused`` tp 2 and dp 2 logits within
     1e-4 of the single card's; the time per forward of two ranks sharing
     one card; the tensor-parallel forward @512 batch 16 (12 K13, 12 K5
     partial, 1 K3 per rank).

 39. the dynamic-batching ``InferenceServer`` on the card (max_batch 64,
     batch_pad 32, 5 ms; B/16 @224 ``fused`` bf16): 200 requests of 1-64
     images from ``default_rng(0)`` submitted by 4 threads, every third
     with ``return_probs``, each answer against the same engine's classify
     of that request alone by phase 38's comparator rule, every
     probabilities row summing to 1; the counts set to 0 after warmup and
     read after (12 K1, 12 K2, 1 K3 per batch; fewer batches than
     requests); then fp32 (48 requests: labels equal, top within 1e-5),
     ``quant`` (32: 12 K15, 12 K16, 1 K3 per batch) and ToMe r = 13 on
     ``fused`` (32: 12 K1, 12 K4, 12 K5);
 40. ``vit-tpu-torch-serve --selftest 400`` in-process, saturated and
     ``--staged``, then ``--selftest-rate`` at 50, 70 and 90% of the
     saturated request rate, one line each (img/s, images per batch,
     p50/p99, offered rate, the card); the static forward at batch 64
     beside them; the saturated server's device busy share over 20 batches
     (profiler device time over wall);
 41. the HTTP daemon on an ephemeral port: ``POST /classify`` with 8 images
     in the bin format and with one PNG (bit for bit the engine's),
     ``X-Deadline-Ms: 0`` answered 504, ``/healthz``, ``/metrics`` (the JAX
     daemon's names), ``POST /reload`` to seed-1 weights (then a seed-1
     engine's answers), its counts (12 K1, 12 K2, 1 K3 per batch); then
     ``InferenceEngine.attention_maps`` with ``rollout`` in fp32 on the card
     under ``torch.set_float32_matmul_precision("high")``, within 1e-5 of a
     float64 CPU composition of the same probabilities and within 1e-5 of
     the map's largest value, a TF32 matmul chain's deviation beside it.

``--only PHASE[,PHASE]`` reruns groups of phases (classify 3-6, train 7-10,
regularized 11-14, long 15-19, quant 20-24, tome 25 and 27-30, dh80 26,
per_op 31-33, adamw 34-35, parallel 36-38, serve 39-41); without it every
phase runs.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit, and the one before
that a JSON object with one entry per kernel: its time, its plain twin's,
the least time the card could take for the same work (bytes over 3.35 TB/s
or operations over the dtype's peak — int8 operations over the int8 peak —
whichever is larger), one PyTorch
call's time where one computes the same function, and its launches on the
main path.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

# Stated tolerances, relative to the largest |value| of the plain result
# (at least 1): fp32 2^-16 — only fp32 summation order (K <= 3072) and FMA
# contraction differ; bf16 2^-6 — the kernel and its twin round at the
# same points, so they differ where accumulation order flips a bf16
# rounding: one ulp is at most 2^-7 of the value, and two are allowed.
TOLERANCE = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
B16 = dict(d=768, heads=12, f=3072, t=197)
BATCHES = (100, 3)
KERNELS = {
    "ln_qkv_attn": ("K1", "vit_tpu_torch/csrc/ln_qkv_attn.cu",
                    "vit_tpu/ops/pallas/fused_block.py:229"),
    "out_ln_mlp_residual": ("K2", "vit_tpu_torch/csrc/out_ln_mlp_residual.cu",
                            "vit_tpu/ops/pallas/fused_block.py:608"),
    "layer_norm": ("K3", "vit_tpu_torch/csrc/layer_norm.cu",
                   "vit_tpu/ops/pallas/ln_kernel.py:35"),
}


TRAIN_KERNELS = {
    "out_residual": ("K4", "vit_tpu_torch/csrc/out_residual.cu",
                     "vit_tpu/ops/pallas/fused_block.py:329"),
    "ln_mlp_residual": ("K5", "vit_tpu_torch/csrc/ln_mlp_residual.cu",
                        "vit_tpu/ops/pallas/fused_block.py:440"),
    "ln_qkv_attn_bwd": ("K6", "vit_tpu_torch/csrc/ln_qkv_attn_bwd.cu",
                        "vit_tpu/ops/pallas/backward.py:916"),
    "ln_mlp_out_residual_bwd": ("K7", "vit_tpu_torch/csrc/ln_mlp_out_residual_bwd.cu",
                                "vit_tpu/ops/pallas/backward.py:351"),
}
TRAIN_BATCHES = (64, 3)
TRAIN_STEPS = 5
MEMORIZE_LR = 3e-4  # weight decay 1e-4, optax.adamw's default

REG_KERNELS = {
    "out_residual_train": ("K10", "vit_tpu_torch/csrc/out_residual_train.cu",
                           "vit_tpu/ops/pallas/fused_block.py:377"),
    "ln_mlp_residual_train": ("K11", "vit_tpu_torch/csrc/ln_mlp_residual_train.cu",
                              "vit_tpu/ops/pallas/fused_block.py:531"),
    "ln_mlp_out_residual_bwd_train": ("K12a",
                                      "vit_tpu_torch/csrc/ln_mlp_out_residual_bwd_train.cu",
                                      "vit_tpu/ops/pallas/backward.py:502"),
}
LONG_KERNELS = {
    "flash_attention_fwd": ("K13", "vit_tpu_torch/csrc/flash_attention.cu",
                            "vit_tpu/ops/pallas/flash_attention.py:94"),
    "flash_attention_bwd": ("K14", "vit_tpu_torch/csrc/flash_attention_bwd.cu",
                            "vit_tpu/ops/pallas/flash_attention.py:271"),
    "ln_mlp_residual_bwd": ("K8", "vit_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
                            "vit_tpu/ops/pallas/backward.py:218"),
    "out_residual_bwd": ("K9", "vit_tpu_torch/csrc/out_residual_bwd.cu",
                         "vit_tpu/ops/pallas/backward.py:779"),
}
QUANT_KERNELS = {
    "ln_qkv_attn_q8": ("K15", "vit_tpu_torch/csrc/ln_qkv_attn_q8.cu",
                       "vit_tpu/ops/pallas/quant_kernels.py:152"),
    "out_ln_mlp_residual_q8": ("K16", "vit_tpu_torch/csrc/out_ln_mlp_residual_q8.cu",
                               "vit_tpu/ops/pallas/quant_kernels.py:195"),
    "ln_mlp_residual_q8": ("K17", "vit_tpu_torch/csrc/ln_mlp_residual_q8.cu",
                           "vit_tpu/ops/pallas/quant_kernels.py:260"),
    # K15's stages 1-2 as the long W8A8 block launches them (plain jnp there)
    "ln_qkv_q8": ("K15 stages 1-2", "vit_tpu_torch/csrc/ln_qkv_attn_q8.cu",
                  "vit_tpu/ops/pallas/quant_kernels.py:38"),
}
LONG_IMAGE = 512  # ViT-B/16 @512: T = 1,025, past the 1,024-token switch
LONG_BATCHES = (16, 3)
LONG_T = 2048  # the flash cases' longest sequence, at batch LONG_T_BATCH
LONG_T_BATCH = 4
SWITCH_T = (577, 1025)  # where the switch phase times both blocks
K13_EDGE_T = (1, 15, 16, 17, 63, 64, 65, 197, 1025, 2048)  # phase 15's warp and tile edges

TOME_KERNELS = {
    "out_residual_bwd_train": ("K12c", "vit_tpu_torch/csrc/out_residual_bwd_train.cu",
                               "vit_tpu/ops/pallas/backward.py:705"),
    "ln_mlp_residual_bwd_train": ("K12b", "vit_tpu_torch/csrc/ln_mlp_residual_bwd_train.cu",
                                  "vit_tpu/ops/pallas/backward.py:610"),
}
TOME_R = 13  # the merge count of the JAX package's ToMe benchmark
TOME_RATE_R = (0, 13, 16)  # the classify rates' merge counts
TOME_LR = 1e-4  # the ToMe train CLI runs' AdamW rate
H14 = dict(d=1280, heads=16, t=257, batch=8)  # vit_h_14 @224's widths: dh 80

PER_OP_KERNELS = {
    "scaled_dot_product_attention": ("K21", "vit_tpu_torch/csrc/scaled_dot_product_attention.cu",
                                     "vit_tpu/ops/pallas/attention_kernel.py:56"),
    "mlp": ("K22", "vit_tpu_torch/csrc/mlp.cu", "vit_tpu/ops/pallas/mlp_kernel.py:65"),
}
ADAMW_KERNELS = {
    "adamw_update": ("K20", "vit_tpu_torch/csrc/adamw.cu",
                     "vit_tpu/ops/pallas/adamw_kernel.py:53"),
}
ADAMW_STEPS = 3  # the kernel-vs-twin steps of phase 34
ADAMW_TURNS = 2  # rounds of kernel, fused, fused, kernel in phase 34's timing
TP_KERNELS = {
    "ln_fc1_gelu_q8": ("K18a", "vit_tpu_torch/csrc/ln_fc1_gelu_q8.cu",
                       "vit_tpu/ops/pallas/quant_kernels.py:394"),
    "fc2_q8_partial": ("K18b", "vit_tpu_torch/csrc/fc2_q8_partial.cu",
                       "vit_tpu/ops/pallas/quant_kernels.py:440"),
}
STUDY_KERNELS = {
    "ln_qkv_attn_q8a": ("K19", "vit_tpu_torch/csrc/ln_qkv_attn_q8a.cu",
                        "vit_tpu/ops/pallas/quant_kernels.py:357"),
}
TP_SIZES = (2, 4)  # the shard shapes of phase 36
RANKS = 2  # phase 38's ranks, sharing the one card over gloo
RANKS_TIMEOUT = 420  # s: a rank that hangs fails phase 38
B16_LEAVES = (20, 86_567_656)  # ViT-B/16's params: leaves, elements
TRAIN_LR = 1e-4  # the fused AdamW train CLI run's rate, as the ToMe runs'

REG_P = 0.1  # dropout, and the drop-path rate of the kernel cases
REG_SEED = 0x9E3779B9  # >= 2^31: the full uint32 range reaches the kernels
REG_FLAGS = ["--dropout", str(REG_P), "--drop-path", str(REG_P)]

# the card's peaks (H100 SXM data sheet): dense tensor-core bf16 and fp32
# FMA outside the tensor cores, dense tensor-core int8, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def synth_params(cfg, seed: int = 0) -> dict:
    """Random weights in the port's params tree, numpy, from ``seed``:
    every GEMM matrix N(0, 1/fan_in), the position embedding N(0, 0.02),
    LayerNorm scales 1, biases and the class token 0 — the statistics of
    the reference checkpoint's synthetic stand-in."""
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import vit

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value)
            elif key in ("kernel", "wqkv", "wo", "w1", "w2"):  # [in, out]
                out[key] = rng.normal(0, value.shape[-2] ** -0.5, value.shape).astype(np.float32)
            elif key == "pos_embed":
                out[key] = rng.normal(0, 0.02, value.shape).astype(np.float32)
            else:
                out[key] = (np.ones if "scale" in key else np.zeros)(value.shape, np.float32)
        return out

    return fill(params_to_numpy(vit.init_params(torch.Generator(), cfg)))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of ``fn`` in ms over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def case(tag, dtype, batch, fn, plain, args, flops, library=None, library_ms=None,
         device=False) -> dict:
    """One kernel-vs-twin case: the kernel and its twin on ``args``, the
    operations its function needs, and one PyTorch call computing the same
    function, where there is one (``library``, timed here; or
    ``library_ms``, a function that times it).  ``device``: also the
    kernel's and the library call's device time (profiler), where the
    wrapper's host cost dominates a CUDA-events reading."""
    return dict(tag=tag, dtype=dtype, batch=batch, kernel=lambda: fn(*args),
                plain=lambda: plain(*args), inputs=[a for a in args if torch.is_tensor(a)],
                flops=flops, library=library, library_ms=library_ms, device=device)


def _tag(dtype, b, rows):
    return f"{str(dtype).removeprefix('torch.')} batch {b} (rows {rows})"


def _rand(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    return rn


def kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K1-K3 at B/16 shapes."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.kernels import layer_norm as k3
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 0)
    cases = {name: [] for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in BATCHES:
            rows = b * t
            tag = _tag(dtype, b, rows)
            x = rn(rows, d, scale=2.0, dtype=dtype)
            s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
            a1 = (x, s1, b1n, wqkv, bqkv, h, t, 1e-6)
            ctx = k1.ln_qkv_attn_plain(*a1)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            a2 = (ctx, x, wo, bo, s1, b1n, w1, bb1, w2, bb2, 1e-6, "exact")
            a3 = (x.reshape(b, t, d), s1, b1n, 1e-6)
            cases["ln_qkv_attn"].append(case(tag, dtype, b, k1.ln_qkv_attn, k1.ln_qkv_attn_plain,
                                             a1, 2 * rows * d * 3 * d + 4 * b * t * t * d))
            cases["out_ln_mlp_residual"].append(case(
                tag, dtype, b, k2.out_ln_mlp_residual, k2.out_ln_mlp_residual_plain, a2,
                2 * rows * d * d + 4 * rows * d * f))
            cases["layer_norm"].append(case(
                tag, dtype, b, k3.layer_norm, k3.layer_norm_plain, a3, 0,
                library=lambda a=a3: F.layer_norm(a[0], (d,), a[1], a[2], a[3]), device=True))
    return cases


def bound(flops: float, nbytes: float, dtype, int8_ops: float = 0.0) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move ``nbytes`` once and do ``flops`` at the dtype's peak (and
    ``int8_ops`` at the int8 tensor-core peak)."""
    t_ops = flops / PEAK_FLOPS[dtype] + int8_ops / PEAK_INT8_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_kernels(cases: dict, labels: dict, summary_batch: int) -> dict:
    """Phases 3, 7 and 11: kernel vs plain twin on every output, each held to
    TOLERANCE[dtype] x max(1, its own largest |value|).  -> {kernel:
    summary at bf16 ``summary_batch``}: error, kernel, twin and library
    times, and the bound from this case's inputs and outputs."""
    summary = {}
    for name, kcases in cases.items():
        for c in kcases:
            tag, dtype = c["tag"], c["dtype"]
            got, want = c["kernel"](), c["plain"]()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            torch.cuda.synchronize()
            err, worst = 0.0, 0.0  # largest |d|, and largest |d| / tol
            for i, (g, w) in enumerate(zip(got, want)):
                g, w = g.float(), w.float()
                if g.shape != w.shape or not torch.isfinite(g).all():
                    raise RuntimeError(f"{name} {tag}: output {i} non-finite or misshapen")
                e = (g - w).abs().max().item()
                tol = TOLERANCE[dtype] * max(1.0, w.abs().max().item())
                if not e <= tol:
                    raise RuntimeError(f"{name} {tag}: output {i} max|d|={e:.6g} > tol "
                                       f"{tol:.6g}: kernel disagrees with its plain twin")
                err, worst = max(err, e), max(worst, e / tol)
            ms, plain_ms = cuda_ms(c["kernel"]), cuda_ms(c["plain"])
            lib_ms = (cuda_ms(c["library"]) if c["library"]
                      else c["library_ms"]() if c["library_ms"] else None)
            bound_ms, bound_by = bound(c["flops"], _nbytes(c["inputs"]) + _nbytes(got), dtype)
            rate = f", {c['flops'] / ms / 1e9:.4g} TFLOP/s" if c["flops"] else ""
            dev_ms = ({"device_ms": _device_ms(c["kernel"]),
                       "library_device_ms": _device_ms(c["library"]) if c["library"] else None}
                      if c.get("device") else {})
            device = ""
            if dev_ms:
                k_dev, lib_dev = dev_ms["device_ms"], dev_ms["library_device_ms"]
                device = (f"; device {k_dev:.6g} ms ({bound_ms / k_dev:.1%} of bound), library "
                          f"device {'none' if lib_dev is None else f'{lib_dev:.6g} ms'}")
            log(f"{labels[name][0]} {name} {tag}: {len(got)} output(s), max|d|={err:.6g} "
                f"(at most {worst:.3g} of its tol) kernel {ms:.6g} ms, plain {plain_ms:.6g} ms, "
                f"library {'none' if lib_ms is None else f'{lib_ms:.6g} ms'}, bound "
                f"{bound_ms:.6g} ms ({bound_by}, {bound_ms / ms:.1%} of the kernel's){rate}"
                f"{device}")
            if c.get("summary", dtype == torch.bfloat16 and c["batch"] == summary_batch):
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                                 **dev_ms}
            del got, want
    return summary


def train_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K4-K7 at B/16 training shapes."""
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import out_residual as k4

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 1)
    cases = {name: [] for name in TRAIN_KERNELS}
    mods = {"out_residual": k4, "ln_mlp_residual": k5, "ln_qkv_attn_bwd": k6,
            "ln_mlp_out_residual_bwd": k7}
    for dtype in (torch.bfloat16, torch.float32):
        for b in TRAIN_BATCHES:
            rows = b * t
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            x, ctx, x1, dy, dctx = row(2.0), row(), row(2.0), row(), row()
            args = {
                "out_residual": ((ctx, x, wo, bo), 2 * rows * d * d),
                "ln_mlp_residual": ((x1, s2, b2n, w1, bb1, w2, bb2, 1e-6, "exact"),
                                    4 * rows * d * f),
                "ln_qkv_attn_bwd": ((dctx, dy, x, s1, b1n, wqkv, bqkv, h, t, 1e-6),
                                    6 * rows * d * 3 * d + 10 * b * t * t * d),
                "ln_mlp_out_residual_bwd": ((dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6, "exact"),
                                            10 * rows * d * f + 4 * rows * d * d),
            }
            for name, (a, flops) in args.items():
                cases[name].append(case(_tag(dtype, b, rows), dtype, b, getattr(mods[name], name),
                                        getattr(mods[name], f"{name}_plain"), a, flops))
            # K5's return_u (the pre-GELU stash beside out), off the main path
            a5 = args["ln_mlp_residual"][0]
            cases["ln_mlp_residual"].append(dict(case(
                f"{_tag(dtype, b, rows)} return_u", dtype, b,
                lambda *a: k5.ln_mlp_residual(*a, return_u=True), k5.ln_mlp_residual_u_plain,
                a5, 4 * rows * d * f), summary=False))
    return cases


def reg_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K10-K12a at B/16 training shapes, dropout and
    drop-path REG_P.  A row whose drop-path scale is 0 needs no GEMM work
    (its branch is dropped), so each bound counts the kept rows only."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd_train as k12
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11
    from vit_tpu_torch.ops.kernels import out_residual_train as k10

    d, f, t = B16["d"], B16["f"], B16["t"]
    rn = _rand(dev, 2)
    cases = {name: [] for name in REG_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in TRAIN_BATCHES:
            rows = b * t
            tag = _tag(dtype, b, rows)
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            x, ctx, x1, dy = row(2.0), row(), row(2.0), row()
            dp_a = drop_path_scale_rows(REG_SEED, 4, b, t, REG_P, device=dev)
            dp_m = drop_path_scale_rows(REG_SEED, 5, b, t, REG_P, device=dev)
            kept_a, kept_m = (int((dp != 0).sum()) for dp in (dp_a, dp_m))
            reg = (REG_SEED, REG_P)
            cases["out_residual_train"].append(case(
                tag, dtype, b, k10.out_residual_train, k10.out_residual_train_plain,
                (ctx, x, wo, bo, dp_a, *reg), 2 * kept_a * d * d))
            cases["ln_mlp_residual_train"].append(case(
                tag, dtype, b, k11.ln_mlp_residual_train, k11.ln_mlp_residual_train_plain,
                (x1, s2, b2n, w1, bb1, w2, bb2, dp_m, *reg, 1e-6, "exact"), 4 * kept_m * d * f))
            cases["ln_mlp_out_residual_bwd_train"].append(case(
                tag, dtype, b, k12.ln_mlp_out_residual_bwd_train,
                k12.ln_mlp_out_residual_bwd_train_plain,
                (dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, dp_m, dp_a, *reg, 1e-6, "exact"),
                10 * kept_m * d * f + 4 * kept_a * d * d))
    return cases


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """K14's library time: ``F.scaled_dot_product_attention``'s forward +
    backward on copies of the same inputs, less its forward."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg)  # noqa: E731
    both = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)  # noqa: E731
    return cuda_ms(both) - cuda_ms(fwd)


def long_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K13, K14, K8, K9 at B/16 @512 shapes (T =
    1,025; batch 16 and 3), and K13/K14 at T = 2,048 batch 4.  K13/K14 take
    strided (B, H, T, dh) views of a packed (B*T, 3D) QKV, as the path
    gives them."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import flash_attention as k13
    from vit_tpu_torch.ops.kernels import flash_attention_bwd as k14
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.ops.kernels import out_residual_bwd as k9

    d, h, f = B16["d"], B16["heads"], B16["f"]
    t512 = (LONG_IMAGE // 16) ** 2 + 1
    rn = _rand(dev, 4)
    cases = {name: [] for name in LONG_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        shapes = [(b, t512) for b in LONG_BATCHES] + [(LONG_T_BATCH, LONG_T)]
        for b, t in shapes:
            rows, dh = b * t, d // h
            tag = _tag(dtype, b, rows) + f" T {t}"
            q, k, v = packed_views(rn(rows, 3 * d, dtype=dtype), b, t, h, 3)
            out, lse = k13.flash_attention_fwd_plain(q, k, v, True)
            do = rn(b, h, t, dh, dtype=dtype)
            cases["flash_attention_fwd"].append(case(
                tag, dtype, b, lambda *a: k13.flash_attention_fwd(*a, return_lse=True),
                lambda *a: k13.flash_attention_fwd_plain(*a, True), (q, k, v),
                4 * b * h * t * t * dh,
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)))
            cases["flash_attention_bwd"].append(case(
                tag, dtype, b, k14.flash_attention_bwd, k14.flash_attention_bwd_plain,
                (q, k, v, out, lse, do), 10 * b * h * t * t * dh,
                library_ms=lambda q=q, k=k, v=v, do=do: _sdpa_bwd_ms(q, k, v, do)))
            if t == LONG_T:
                continue
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2 = rn(f, d, scale=f ** -0.5, dtype=dtype)
            wo = rn(d, d, scale=d ** -0.5, dtype=dtype)
            dy, x1, ctx = row(), row(2.0), row()
            cases["ln_mlp_residual_bwd"].append(case(
                tag, dtype, b, k8.ln_mlp_residual_bwd, k8.ln_mlp_residual_bwd_plain,
                (dy, x1, s2, b2n, w1, bb1, w2, 1e-6, "exact"), 10 * rows * d * f))
            cases["out_residual_bwd"].append(case(
                tag, dtype, b, k9.out_residual_bwd, k9.out_residual_bwd_plain,
                (dy, ctx, wo), 4 * rows * d * d))
    return cases


def phase_k13_edges(dev: torch.device) -> None:
    """Phase 15, continued: the bf16 K13 on its register tiles at T around
    every 16-row warp edge and 64-row tile edge up to 2,048, at every head
    width, batch 3 on strided views of a packed QKV writing a packed
    context: out and lse within TOLERANCE of the twin's (not timed)."""
    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import flash_attention as k13

    rn = _rand(dev, 15)
    worst, b, h, dtype = 0.0, 3, 2, torch.bfloat16
    for dh in k13.HEAD_DIMS:
        for t in K13_EDGE_T:
            q, k, v = packed_views(rn(b * t, 3 * h * dh, scale=2.0, dtype=dtype), b, t, h, 3)
            ctx = torch.zeros(b * t, h * dh, dtype=dtype, device=dev)
            (out,) = packed_views(ctx, b, t, h, 1)
            _, lse = k13.flash_attention_fwd(q, k, v, out=out, return_lse=True)
            want, want_lse = k13.flash_attention_fwd_plain(q, k, v, True)
            for what, got, ref in (("out", out, want), ("lse", lse, want_lse)):
                e = (got.float() - ref.float()).abs().max().item()
                tol = TOLERANCE[dtype] * max(1.0, ref.float().abs().max().item())
                if not (e <= tol and torch.isfinite(got).all()):
                    raise RuntimeError(f"K13 bf16 T {t} dh {dh} {what}: max|d|={e:.6g} > {tol:.6g}")
                worst = max(worst, e / tol)
    log(f"K13 flash_attention_fwd bf16 at T {', '.join(map(str, K13_EDGE_T))} x dh "
        f"{', '.join(map(str, k13.HEAD_DIMS))} (batch {b}, {h} heads): out and lse at most "
        f"{worst:.3g} of their tolerance")


def _kept(frac: float, n: int, p: float, site: str) -> str:
    """Check a kept fraction against 1 - p within 4 sigma of n Bernoulli draws."""
    sigma = math.sqrt(p * (1 - p) / n)
    z = (frac - (1 - p)) / sigma
    if not abs(z) <= 4:
        raise RuntimeError(f"{site}: kept fraction {frac:.6g} is {z:.3g} sigma from {1 - p}")
    return f"{site} {frac:.6g} ({z:+.3g} sigma of {n})"


def phase_regularizer_checks(dev: torch.device) -> None:
    """Phase 11's exact checks at B/16 batch 64: K10's zeros are the twin's;
    at zero rates K10/K11/K12a/K12c equal K4/K5/K7/K9 bit for bit; each dropout
    site's kept fraction, read off a kernel output, is within 4 sigma of
    1 - p (the drop-path sites from the row scales the kernels read)."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd_train as k12
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11
    from vit_tpu_torch.ops.kernels import out_residual as k4
    from vit_tpu_torch.ops.kernels import out_residual_bwd as k9
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c
    from vit_tpu_torch.ops.kernels import out_residual_train as k10

    d, f, t, b = B16["d"], B16["f"], B16["t"], 64
    rows, p, reg = b * t, REG_P, (REG_SEED, REG_P)
    rn = _rand(dev, 3)
    ones = torch.ones(rows, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        ctx, x1, dy = rn(rows, d, dtype=dtype), rn(rows, d, scale=2.0, dtype=dtype), rn(rows, d, dtype=dtype)
        wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
        w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        zero = torch.zeros(rows, d, dtype=dtype, device=dev)

        # the attention-out mask: K10 with a zero residual and no drop-path
        out = k10.out_residual_train(ctx, zero, wo, bo, ones, *reg)
        want = k10.out_residual_train_plain(ctx, zero, wo, bo, ones, *reg)
        if not torch.equal(out == 0, want == 0):
            raise RuntimeError(f"K10 {name}: its zeros differ from the twin's (the mask pattern)")
        sites = [_kept((out != 0).float().mean().item(), out.numel(), p, "attention-out")]

        # the MLP sites: K11 with x = 0, W1 = 0, b1 = 3 (so gelu(u) is one
        # constant), W2 = [I; 0], b2 = 0 -> out = round(gelu(3) m_in) m_out
        # on the first D inner columns; with W2 = 0, b2 = 1 -> out = m_out
        eye = torch.zeros(f, d, dtype=dtype, device=dev)
        eye[:d] = torch.eye(d, dtype=dtype, device=dev)
        zf = torch.zeros(d, f, dtype=dtype, device=dev)
        threes, zd = torch.full((f,), 3.0, dtype=dtype, device=dev), torch.zeros(d, dtype=dtype, device=dev)
        m_out = k11.ln_mlp_residual_train(zero, s2, b2n, zf, threes, torch.zeros_like(eye),
                                          torch.ones_like(zd), ones, *reg, 1e-6) != 0
        both = k11.ln_mlp_residual_train(zero, s2, b2n, zf, threes, eye, zd, ones, *reg, 1e-6) != 0
        if (both & ~m_out).any():
            raise RuntimeError(f"K11 {name}: an output the MLP-out mask drops is not zero")
        sites.append(_kept(m_out.float().mean().item(), m_out.numel(), p, "mlp-out"))
        n_out = int(m_out.sum())
        sites.append(_kept(int(both.sum()) / n_out, n_out, p, "mlp-inner"))
        for site in (4, 5):
            dp = drop_path_scale_rows(REG_SEED, site, b, t, p, device=dev)[::t]
            sites.append(_kept((dp != 0).float().mean().item(), b, p, f"drop-path site {site}"))
        log(f"K10/K11 {name} batch {b}: K10's zeros equal the twin's; kept fractions: "
            + ", ".join(sites))

        # zero rates: the gates compile out and dp multiplies by 1
        same = [
            torch.equal(k10.out_residual_train(ctx, x1, wo, bo, ones, REG_SEED, 0.0),
                        k4.out_residual(ctx, x1, wo, bo)),
            torch.equal(k11.ln_mlp_residual_train(x1, s2, b2n, w1, bb1, w2, bb2, ones, REG_SEED,
                                                  0.0, 1e-6),
                        k5.ln_mlp_residual(x1, s2, b2n, w1, bb1, w2, bb2, 1e-6)),
            all(torch.equal(a, c) for a, c in zip(
                k12.ln_mlp_out_residual_bwd_train(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, ones,
                                                  ones, REG_SEED, 0.0, 1e-6),
                k7.ln_mlp_out_residual_bwd(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6))),
            all(torch.equal(a, c) for a, c in zip(
                k12c.out_residual_bwd_train(dy, ctx, wo, ones, REG_SEED, 0.0),
                k9.out_residual_bwd(dy, ctx, wo))),
        ]
        log(f"zero rates {name} batch {b}: K10 == K4 {same[0]}, K11 == K5 {same[1]}, "
            f"K12a == K7 {same[2]}, K12c == K9 {same[3]} (bit for bit)")
        if not all(same):
            raise RuntimeError("a regularized kernel at zero rates differs from its plain kernel")


def phase_k7_shares_k8(dev: torch.device) -> None:
    """Phase 7's chain check at B/16 batch 64, bf16: K7 runs K8's chain
    (``csrc/mlp_bwd_mma.cuh``) with the out_proj tail after it, so its MLP
    outputs (dx1, dgamma, dbeta, dW1, db1, dW2, db2) equal K8's on the same
    inputs bit for bit."""
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8

    d, f, t, b, bf = B16["d"], B16["f"], B16["t"], 64, torch.bfloat16
    rows = b * t
    rn = _rand(dev, 4)
    dy, x1, ctx = rn(rows, d, dtype=bf), rn(rows, d, scale=2.0, dtype=bf), rn(rows, d, dtype=bf)
    s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=bf), rn(d, scale=0.2, dtype=bf)
    w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=bf), rn(f, scale=0.1, dtype=bf)
    w2, wo = rn(f, d, scale=f ** -0.5, dtype=bf), rn(d, d, scale=d ** -0.5, dtype=bf)
    got = k7.ln_mlp_out_residual_bwd(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6)
    want = k8.ln_mlp_residual_bwd(dy, x1, s2, b2n, w1, bb1, w2, 1e-6)
    names = ("dx1", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2")
    differ = [n for n, a, c in zip(names, (got[0], *got[2:8]), want) if not torch.equal(a, c)]
    log(f"K7 == K8 bfloat16 batch {b} (rows {rows}): the MLP outputs {', '.join(names)} "
        f"{'differ: ' + ', '.join(differ) if differ else 'equal'} (bit for bit)")
    if differ:
        raise RuntimeError(f"K7's MLP outputs {differ} differ from K8's on the same inputs")


def phase_k9_shares_k7(dev: torch.device) -> None:
    """Phase 7's tail check at B/16 batch 64, bf16: K9 runs the bf16 K7's
    out_proj tail (``out_proj_bwd_mma``), so on K7's own bf16 dx1 its dctx
    and dW_o equal K7's bit for bit; db_o only within tolerance, because
    K9 sums the bf16 dx1 it is given where K7 sums its fp32 dx1 before the
    rounding.  Two runs of K9 give the same bits (fixed-order reductions,
    a split picked from the shape alone)."""
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import out_residual_bwd as k9

    d, f, t, b, bf = B16["d"], B16["f"], B16["t"], 64, torch.bfloat16
    rows = b * t
    rn = _rand(dev, 9)
    dy, x1, ctx = rn(rows, d, dtype=bf), rn(rows, d, scale=2.0, dtype=bf), rn(rows, d, dtype=bf)
    s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=bf), rn(d, scale=0.2, dtype=bf)
    w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=bf), rn(f, scale=0.1, dtype=bf)
    w2, wo = rn(f, d, scale=f ** -0.5, dtype=bf), rn(d, d, scale=d ** -0.5, dtype=bf)
    got7 = k7.ln_mlp_out_residual_bwd(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6)
    dx1, dctx7, dwo7, dbo7 = got7[0], got7[1], got7[8], got7[9]
    dctx, dwo, dbo = k9.out_residual_bwd(dx1, ctx, wo)
    again = k9.out_residual_bwd(dx1, ctx, wo)
    differ = [n for n, a, c in (("dctx", dctx, dctx7), ("dW_o", dwo, dwo7))
              if not torch.equal(a, c)]
    e = (dbo - dbo7).abs().max().item()
    tol = TOLERANCE[bf] * max(1.0, dbo7.abs().max().item())
    rerun = all(torch.equal(a, c) for a, c in zip((dctx, dwo, dbo), again))
    verdict = "differ: " + ", ".join(differ) if differ else "equal K7's"
    log(f"K9 on K7's dx1 bfloat16 batch {b} (rows {rows}): dctx, dW_o {verdict} (bit for "
        f"bit); db_o max|d|={e:.6g} <= {tol:.6g} (K9 sums the bf16 dx1, K7 its fp32 dx1); two "
        f"runs of K9 {'the same bits' if rerun else 'DIFFER'}")
    if differ or not e <= tol or not rerun:
        raise RuntimeError(f"K9 on K7's dx1: {differ or ''} db_o {e:.6g} (tol {tol:.6g}); "
                           f"two runs equal {rerun}")


def _kernel_split(fn, label: str, card: str, calls: int = 10) -> None:
    """The device kernels one call of ``fn`` launches, in launch order, each
    with its device time per call (a torch.profiler trace over ``calls``
    calls) and its share of the call's kernel time.  A kernel's launches
    per call are its launches in the trace over ``calls``, rounded up, and
    its time per call its mean per launch times that: a trace that lost
    some of a kernel's records (it then says how many it holds) still gives
    its time per call, and one that holds no device record at all is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        order, by_name = [], {}
        for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
                        key=lambda e: e.time_range.start):
            if e.name not in by_name:
                order.append(e.name)
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        if by_name:
            break
        log(f"{label}: trace {attempt} holds no device kernel record")
    per_call = {name: (ms / n * -(-n // calls), -(-n // calls), n)
                for name, (ms, n) in by_name.items()}
    total = sum(ms for ms, _, _ in per_call.values())
    log(f"{label}: device kernels {total:.6g} ms per call, in launch order; {card}")
    for name in order:
        ms, launches, n = per_call[name]
        seen = "" if n == launches * calls else f" ({n} in the trace of {calls} calls)"
        log(f"  {ms:.6g} ms ({ms / total:.1%}) in {launches} launch(es){seen}: {name[:120]}")


def phase_k5_split(dev: torch.device, card: str) -> None:
    """Phase 7's split of the bf16 K5 and K11 by CUDA kernel at B/16 batch
    64: the LN2 row pass, FC1 and FC2 on the tensor-core core (K11 at
    dropout and drop-path REG_P)."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11

    d, f, t, b, bf = B16["d"], B16["f"], B16["t"], 64, torch.bfloat16
    rows = b * t
    rn = _rand(dev, 5)
    args = (rn(rows, d, scale=2.0, dtype=bf), rn(d, scale=0.2, shift=1.0, dtype=bf),
            rn(d, scale=0.2, dtype=bf), rn(d, f, scale=d ** -0.5, dtype=bf),
            rn(f, scale=0.1, dtype=bf), rn(f, d, scale=f ** -0.5, dtype=bf),
            rn(d, scale=0.1, dtype=bf))
    dp = drop_path_scale_rows(REG_SEED, 5, b, t, REG_P, device=dev)
    _kernel_split(lambda: k5.ln_mlp_residual(*args, 1e-6),
                  f"K5 ln_mlp_residual bfloat16 batch {b} (rows {rows}) by kernel", card)
    _kernel_split(lambda: k11.ln_mlp_residual_train(*args, dp, REG_SEED, REG_P, 1e-6),
                  f"K11 ln_mlp_residual_train bfloat16 batch {b} (rows {rows}) p {REG_P} "
                  "by kernel", card)


def phase_k16_split(dev: torch.device, card: str) -> None:
    """Phase 20's split of the bf16 K16 by CUDA kernel at B/16 batch 100:
    the two K-major weight copies, the out_proj on the bf16 core, LN2 +
    quantize, FC1 on the int8 core, the mid quantizer, FC2."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual_q8 as k16

    d, f, rows, bf = B16["d"], B16["f"], 100 * B16["t"], torch.bfloat16
    rn = _rand(dev, 16)
    args = (rn(rows, d, dtype=bf), rn(rows, d, scale=2.0, dtype=bf),
            rn(d, d, scale=d ** -0.5, dtype=bf), rn(d, scale=0.1, dtype=bf),
            rn(d, scale=0.2, shift=1.0, dtype=bf), rn(d, scale=0.2, dtype=bf),
            *quant.quantize_weight(rn(d, f, scale=d ** -0.5)), rn(f, scale=0.1, dtype=bf),
            *quant.quantize_weight(rn(f, d, scale=f ** -0.5)), rn(d, scale=0.1, dtype=bf), 1e-6)
    _kernel_split(lambda: k16.out_ln_mlp_residual_q8(*args),
                  f"K16 out_ln_mlp_residual_q8 bfloat16 batch 100 (rows {rows}) by kernel", card)


def phase_k15_split(dev: torch.device, card: str) -> None:
    """Phase 20's split of the bf16 K15 by CUDA kernel at B/16 batch 100:
    the K-major copy of Wq, LN1 + quantize, the QKV GEMM on the int8 core,
    attention on K1's register tiles."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, t, bf = B16["d"], B16["heads"], B16["t"], torch.bfloat16
    rows = 100 * t
    rn = _rand(dev, 15)
    args = (rn(rows, d, scale=2.0, dtype=bf), rn(d, scale=0.2, shift=1.0, dtype=bf),
            rn(d, scale=0.2, dtype=bf), *quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5)),
            rn(3 * d, scale=0.1, dtype=bf), h, t, 1e-6)
    _kernel_split(lambda: k15.ln_qkv_attn_q8(*args),
                  f"K15 ln_qkv_attn_q8 bfloat16 batch 100 (rows {rows}) by kernel", card)


def phase_k17_split(dev: torch.device, card: str) -> None:
    """Phase 20's split of the bf16 K17 by CUDA kernel at B/16 batch 100:
    the two K-major weight copies, LN2 + quantize, FC1 on the int8 core, the
    mid quantizer, FC2."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as k17

    d, f, rows, bf = B16["d"], B16["f"], 100 * B16["t"], torch.bfloat16
    rn = _rand(dev, 17)
    args = (rn(rows, d, scale=2.0, dtype=bf), rn(d, scale=0.2, shift=1.0, dtype=bf),
            rn(d, scale=0.2, dtype=bf), *quant.quantize_weight(rn(d, f, scale=d ** -0.5)),
            rn(f, scale=0.1, dtype=bf), *quant.quantize_weight(rn(f, d, scale=f ** -0.5)),
            rn(d, scale=0.1, dtype=bf), 1e-6)
    _kernel_split(lambda: k17.ln_mlp_residual_q8(*args),
                  f"K17 ln_mlp_residual_q8 bfloat16 batch 100 (rows {rows}) by kernel", card)


def phase_k22_split(dev: torch.device, card: str) -> None:
    """Phase 31's split of the bf16 K22 by CUDA kernel at B/16 batch 100:
    FC1 + GELU and FC2 on the bf16 core."""
    from vit_tpu_torch.ops.kernels import mlp as k22

    d, f, b, t, bf = B16["d"], B16["f"], 100, B16["t"], torch.bfloat16
    rn = _rand(dev, 22)
    args = (rn(b, t, d, scale=2.0, dtype=bf), rn(d, f, scale=d ** -0.5, dtype=bf),
            rn(f, scale=0.1, dtype=bf), rn(f, d, scale=f ** -0.5, dtype=bf),
            rn(d, scale=0.1, dtype=bf))
    _kernel_split(lambda: k22.mlp(*args), f"K22 mlp bfloat16 batch {b} (rows {b * t}) by kernel",
                  card)


def phase_k6_split(dev: torch.device, card: str) -> None:
    """Phase 7's split of the bf16 K6 by CUDA kernel at B/16 batch 64: the
    row passes, the three GEMMs, the attention backward's statistics, dK/dV
    and dQ kernels and the column sums, plain (T 197) and with token
    merging's bias and no residual join (T 171)."""
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6

    d, h, b, bf = B16["d"], B16["heads"], 64, torch.bfloat16
    rn = _rand(dev, 6)
    s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=bf), rn(d, scale=0.2, dtype=bf)
    wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=bf), rn(3 * d, scale=0.1, dtype=bf)
    for t, hooked in ((B16["t"], False), (_merged_counts(TOME_R, 2)[2], True)):
        rows = b * t
        dctx, dres, x = rn(rows, d, dtype=bf), rn(rows, d, dtype=bf), rn(rows, d, scale=2.0,
                                                                         dtype=bf)
        kw = {"log_size": _log_size(dev, b, t)} if hooked else {}
        args = (dctx, None if hooked else dres, x, s1, b1n, wqkv, bqkv, h, t, 1e-6)
        _kernel_split(lambda: k6.ln_qkv_attn_bwd(*args, **kw),
                      f"K6 ln_qkv_attn_bwd bfloat16 batch {b} T {t}"
                      f"{' log_size dres=None' if hooked else ''} by kernel", card)


def phase_k9_split(dev: torch.device, card: str) -> None:
    """Phase 15's split of the bf16 K9 by CUDA kernel at @512 batch 16
    (16,400 rows) and at ToMe's batch 64 T 171 (10,944 rows), and of K12c
    there at dropout and drop-path REG_P: the gate rows (K12c), the column
    sum and its finish, the dctx GEMM, the split weight gradient and its
    partial sum."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import out_residual_bwd as k9
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    d, bf = B16["d"], torch.bfloat16
    rn = _rand(dev, 19)
    wo = rn(d, d, scale=d ** -0.5, dtype=bf)
    t_tome = _merged_counts(TOME_R, 2)[2]
    for b, t in ((LONG_BATCHES[0], (LONG_IMAGE // 16) ** 2 + 1), (64, t_tome)):
        rows = b * t
        dx1, ctx = rn(rows, d, dtype=bf), rn(rows, d, dtype=bf)
        _kernel_split(lambda: k9.out_residual_bwd(dx1, ctx, wo),
                      f"K9 out_residual_bwd bfloat16 batch {b} T {t} (rows {rows}) by kernel", card)
    # K12c on the ToMe rows' dx1 and ctx, the loop's last
    dp = drop_path_scale_rows(REG_SEED, 4, 64, t_tome, REG_P, device=dev)
    _kernel_split(lambda: k12c.out_residual_bwd_train(dx1, ctx, wo, dp, REG_SEED, REG_P),
                  f"K12c out_residual_bwd_train bfloat16 batch 64 T {t_tome} (rows {rows}) "
                  f"p {REG_P} by kernel", card)


def phase_k4_split(dev: torch.device, card: str) -> None:
    """Phase 7's split of the bf16 K4 and K10 by CUDA kernel: one GEMM on the
    TMA + ``wgmma`` core each, at B/16 batch 64 T 197 (12,608 rows, the @224
    step's), @512 batch 16 (16,400, the long step's) and batch 100 T 158
    (15,800, ToMe r = 13's first merged classify layer); K10 at dropout and
    drop-path REG_P."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import out_residual as k4
    from vit_tpu_torch.ops.kernels import out_residual_train as k10

    d, bf = B16["d"], torch.bfloat16
    rn = _rand(dev, 4)
    wo, bo = rn(d, d, scale=d ** -0.5, dtype=bf), rn(d, scale=0.1, dtype=bf)
    for b, t in ((64, B16["t"]), (LONG_BATCHES[0], (LONG_IMAGE // 16) ** 2 + 1),
                 (100, _merged_counts(TOME_R, 3)[1])):
        rows = b * t
        ctx, res = rn(rows, d, dtype=bf), rn(rows, d, scale=2.0, dtype=bf)
        dp = drop_path_scale_rows(REG_SEED, 4, b, t, REG_P, device=dev)
        _kernel_split(lambda: k4.out_residual(ctx, res, wo, bo),
                      f"K4 out_residual bfloat16 batch {b} T {t} (rows {rows}) by kernel", card)
        _kernel_split(lambda: k10.out_residual_train(ctx, res, wo, bo, dp, REG_SEED, REG_P),
                      f"K10 out_residual_train bfloat16 batch {b} T {t} (rows {rows}) p {REG_P} "
                      "by kernel", card)
        del ctx, res


def phase_k18_split(dev: torch.device, card: str) -> None:
    """Phase 36's split of the bf16 K18a and of K18b by CUDA kernel at rank
    0's shard of B/16 batch 100 for tp 2 and 4: K18a's K-major W1q copy,
    LN2 + quantize rows and FC1 on the int8 core (``fast_erf``, the
    tensor-parallel MLP's form); K18b's K-major W2q copy, the requantize
    rows and FC2 with its int32 store."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a

    d, f, rows, bf = B16["d"], B16["f"], BATCHES[0] * B16["t"], torch.bfloat16
    rn = _rand(dev, 18)
    x, s2, b2n = (rn(rows, d, scale=2.0, dtype=bf), rn(d, scale=0.2, shift=1.0, dtype=bf),
                  rn(d, scale=0.2, dtype=bf))
    (w1q, w1s), bb1 = quant.quantize_weight(rn(d, f, scale=d ** -0.5)), rn(f, scale=0.1, dtype=bf)
    w2q, _ = quant.quantize_weight(rn(f, d, scale=f ** -0.5))
    for tp in TP_SIZES:
        c = slice(0, f // tp)
        a18a = (x, s2, b2n, w1q[:, c].contiguous(), w1s[c].contiguous(), bb1[c].contiguous(),
                1e-6, "exact", True)
        mid = k18a.ln_fc1_gelu_q8(*a18a)
        mmax = mid.abs().amax(-1, keepdim=True)
        ms = torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)
        w2 = w2q[c].contiguous()
        tag = f"bfloat16 batch {BATCHES[0]} (rows {rows}) tp {tp} (rank 0: F/tp {f // tp})"
        _kernel_split(lambda: k18a.ln_fc1_gelu_q8(*a18a), f"K18a ln_fc1_gelu_q8 {tag} by kernel",
                      card)
        _kernel_split(lambda: k18b.fc2_q8_partial(mid, ms, w2),
                      f"K18b fc2_q8_partial {tag} by kernel", card)
        del mid


def phase_k19_split(dev: torch.device, card: str) -> None:
    """Phase 37's split of the bf16 K19 by CUDA kernel at B/16 batch 100,
    with int8 p·v and with p·v in bf16: K15's stages 1-2 (the K-major copy
    of Wq, LN1 + quantize, the QKV GEMM on the int8 core), the code passes
    of q and k (and v), the attention on int8 register tiles."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, t, bf = B16["d"], B16["heads"], B16["t"], torch.bfloat16
    rows = BATCHES[0] * t
    rn = _rand(dev, 19)
    args = (rn(rows, d, scale=2.0, dtype=bf), rn(d, scale=0.2, shift=1.0, dtype=bf),
            rn(d, scale=0.2, dtype=bf), *quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5)),
            rn(3 * d, scale=0.1, dtype=bf), h, t, 1e-6)
    for qpv in (True, False):
        _kernel_split(lambda: k15.ln_qkv_attn_q8a(*args, quant_pv=qpv),
                      f"K19 ln_qkv_attn_q8a quant_pv={qpv} bfloat16 batch {BATCHES[0]} "
                      f"(rows {rows}) by kernel", card)


PROFILE_PHASES = ("patch_embed+pos", "layer_norm_1", "attention", "layer_norm_2", "mlp",
                  "final_ln+head")
PROFILE_ITERS = 3  # InferenceEngine.phase_report's default


def phase_cli(params, workdir: str, ops: str = "fused",
              kernels=("ln_qkv_attn", "out_ln_mlp_residual"), extra=(), final_ln: int = 1,
              more=None) -> dict:
    """Phases 4, 21, 27 and 32: the classify CLI on the card with ``--ops
    ops`` and ``extra`` flags, on ``params`` saved as an npz: 12 launches of
    each of ``kernels``, ``final_ln`` of K3, ``more`` ({kernel: launches})
    on top, none of any other; with ``--profile`` among ``extra``, the six
    phase lines of ``phase_report``.  -> launch counts of its run."""
    from vit_tpu_torch.cli.main import main
    from vit_tpu_torch.eval import comparator
    from vit_tpu_torch.io import checkpoint

    weights = f"{workdir}/params.npz"
    checkpoint.save_npz(params, weights)
    result = f"{workdir}/result.txt"
    buf = io.StringIO()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--weights", weights, "--synth", "100", "--ops", ops, "--dtype", "bfloat16",
            "--device", "cuda", "--batch-pad", "100", "--json", "--output", result, *extra,
        ])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    out = buf.getvalue().splitlines()
    tag = " ".join(["cli --ops", ops, *extra])
    log("\n".join([f"{tag}: " + line for line in out[:3] + out[-2:]]))
    log(f"{tag}: rc {rc}, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"classify CLI exited {rc}")
    fmt = re.compile(r"^\[\d+\] label: \d+ / prob: \d+\.\d{6}")
    if sum(bool(fmt.match(line)) for line in out) != 100:
        raise RuntimeError("classify CLI did not print 100 result lines")
    if [r.index for r in comparator.parse_result_file(result)] != list(range(100)):
        raise RuntimeError("classify CLI's --output is not 100 well-formed lines")
    want = {name: 0 for name in wrappers}
    want.update({name: 12 for name in kernels}, layer_norm=final_ln)
    for name, n in (more or {}).items():
        want[name] += n
    if launches != want:
        raise RuntimeError(f"{tag}: expected launches {want}, got {launches}")
    if "--profile" in extra:
        rows = [line.split() for line in out if " ms total " in line]
        log("\n".join(f"{tag}: " + " ".join(r) for r in rows))
        per_layer = PROFILE_ITERS * 12
        counts = {r[0]: int(r[-1].removeprefix("x")) for r in rows}
        if counts != {name: PROFILE_ITERS if name in ("patch_embed+pos", "final_ln+head")
                      else per_layer for name in PROFILE_PHASES}:
            raise RuntimeError(f"{tag}: phase lines {counts}, expected the six phases")
    return launches


def _probs(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _comparator_rule(what: str, p: np.ndarray, p32: np.ndarray) -> None:
    """bench.py's rule for a lower-precision path against fp32 probabilities
    ``p32``: no label differs where fp32's top-1 beats its top-2 by more
    than 0.01, and the top probability moves by at most 0.01."""
    l32, lp = p32.argmax(-1), p.argmax(-1)
    n = len(l32)
    top2 = np.sort(p32, -1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 0.01
    n_bad = int(((lp != l32) & decisive).sum())
    prob_dev = float(np.abs(p[np.arange(n), lp] - p32[np.arange(n), l32]).max())
    log(f"{what}, {n} images: {int(decisive.sum())} decisive, "
        f"{n_bad} decisive label mismatches (tol 0), {int((lp != l32).sum())} mismatches in all, "
        f"top-prob max|d|={prob_dev:.6g} (tol 0.01)")
    if n_bad or not prob_dev <= 0.01:
        raise RuntimeError(f"{what}: fails the comparator rule")


def phase_correctness(params, images: np.ndarray, dev: torch.device) -> None:
    """Phase 5: fused vs eager (card, fp32), vs eager fp64 (CPU), bf16 vs fp32."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    fused32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=1)
    eager32 = InferenceEngine(cfg, params, "float32", "eager", dev, batch_pad=1)
    f32 = fused32.logits(images[:8]).cpu().numpy()
    e32 = eager32.logits(images[:8]).cpu().numpy()
    del eager32
    if f32.shape != (8, cfg.num_classes) or not np.isfinite(f32).all():
        raise RuntimeError(f"fp32 fused logits: shape {f32.shape} or non-finite")
    dev_eager = float(np.abs(f32 - e32).max())
    log(f"fp32 fused vs fp32 eager (card, TF32 off), 8 images: max|d logit|={dev_eager:.6g} (tol 1e-3)")
    with torch.inference_mode():
        e64 = vit.forward(
            params_from_numpy(params, "cpu", torch.float64),
            torch.from_numpy(images[:2]).double(), cfg,
        ).numpy()
    dev_f64 = float(np.abs(f32[:2] - e64).max())
    log(f"fp32 fused (card) vs eager float64 (CPU), 2 images: max|d logit|={dev_f64:.6g} (tol 1e-3)")
    if not (dev_eager <= 1e-3 and dev_f64 <= 1e-3):
        raise RuntimeError("fp32 fused logits outside 1e-3 of the eager path")

    p32 = _probs(fused32.logits(images).cpu().numpy())
    del fused32
    fused16 = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=1)
    p16 = _probs(fused16.logits(images).cpu().numpy())
    _comparator_rule("bf16 fused vs fp32 fused", p16, p32)


def _inference_rates(cfg, params, x, ops_list, dev, card: str, what: str, rounds: int) -> dict:
    """img/s of ``InferenceEngine.logits`` on the device batch ``x``, bf16,
    for each op table of ``ops_list``, timed in turns (a b c c b a per
    round), and the peak device memory of one forward of each: its own
    params, ``x`` and its activations, whatever else is on the card."""
    from vit_tpu_torch.runtime.engine import InferenceEngine

    n = x.shape[0]
    engines, peak = {}, {}
    for ops in ops_list:
        gc.collect()  # earlier phases' garbage freed here would make the peak read negative
        others = torch.cuda.memory_allocated() - x.numel() * x.element_size()
        engines[ops] = InferenceEngine(cfg, params, "bfloat16", ops, dev, batch_pad=n)
        engines[ops].logits(x)  # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engines[ops].logits(x)
        peak[ops] = (torch.cuda.max_memory_allocated() - others) / 2 ** 30
    times = {ops: [] for ops in engines}
    for _ in range(rounds):
        for ops in (*ops_list, *ops_list[::-1]):
            t0 = time.perf_counter()
            engines[ops].logits(x)
            torch.cuda.synchronize()
            times[ops].append(time.perf_counter() - t0)
    rates = {ops: n / statistics.median(t) for ops, t in times.items()}
    for ops, ts in times.items():
        log(f"{what} {ops} {cfg.name} batch {n} bf16: {rates[ops]:.6g} img/s (median of "
            f"{len(ts)}, forward {statistics.median(ts) * 1e3:.6g} ms); peak device memory "
            f"{peak[ops]:.6g} GiB; {card}")
    return rates


def _profile_forward(cfg, params, x, ops: str, dev, card: str, tome_r: int = 0) -> None:
    """One ``InferenceEngine.logits`` forward (at ToMe ``tome_r``) in a
    torch.profiler trace: its wall time, its kernels' device time by name
    (annotations on the device timeline not counted, as in ``_device_ms``)
    and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(cfg, params, "bfloat16", ops, dev, batch_pad=x.shape[0],
                             tome_r=tome_r)
    engine.logits(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.logits(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    what = f"{ops} ToMe r={tome_r}" if tome_r else ops
    log(f"profile {what} {cfg.name} batch {x.shape[0]} bf16: forward {wall:.6g} ms wall (profiler "
        f"on), device kernels {busy:.6g} ms ({busy / wall:.1%} busy, idle {1 - busy / wall:.1%}); "
        f"{card}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:.6g} ms ({ms / busy:.1%}) in {n} launches: {name[:110]}")


def phase_throughput(params, images: np.ndarray, dev: torch.device, card: str) -> dict:
    """Phase 6: images/s at batch 100 bf16, fused and eager timed in turns;
    then one fused forward in a profiler trace."""
    from vit_tpu_torch.config import VIT_B_16

    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    rates = _inference_rates(VIT_B_16, params, x, ("fused", "eager"), dev, card, "throughput", 5)
    gc.collect()
    torch.cuda.empty_cache()
    _profile_forward(VIT_B_16, params, x, "fused", dev, card)
    return rates


def all_wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each carries ``launches``)."""
    from vit_tpu_torch.ops.kernels import wrapper

    return {name: wrapper(name) for name in (*KERNELS, *TRAIN_KERNELS, *REG_KERNELS, *LONG_KERNELS,
                                             *QUANT_KERNELS, *TOME_KERNELS, *PER_OP_KERNELS,
                                             *ADAMW_KERNELS, *TP_KERNELS, *STUDY_KERNELS)}


def _reset_counts() -> dict:
    """Every wrapper by name, its launch count set to 0."""
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _expect_counts(wrappers: dict, want: dict, what: str) -> dict:
    """Read every count; fail unless ``want`` (the rest 0)."""
    return _expect_counts_of({name: fn.launches for name, fn in wrappers.items()}, want, what)


def _expect_counts_of(launches: dict, want: dict, what: str) -> dict:
    """Fail unless the counts ``launches`` are ``want`` (the rest 0)."""
    expected = {name: 0 for name in launches}
    expected.update(want)
    log(f"{what}: launches {launches}")
    if launches != expected:
        raise RuntimeError(f"{what}: expected launches {expected}, got {launches}")
    return launches


def _train_cli(workdir: str, extra) -> tuple:
    """The train CLI on the card (B/16, 5 steps, batch 64, fused_train, bf16
    mixed) with ``extra`` flags; every count set to 0 just before and read
    just after.  -> (launch counts, losses)."""
    from vit_tpu_torch.cli.train import main

    log_path = f"{workdir}/train{len(extra)}.jsonl"
    buf = io.StringIO()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--config", "vit_b_16", "--steps", str(TRAIN_STEPS), "--batch", "64",
            "--ops", "fused_train", "--mixed-precision", "--device", "cuda",
            "--log-jsonl", log_path, *extra,
        ])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    tag = "train cli" + (" " + " ".join(extra) if extra else "")
    log("\n".join(f"{tag}: " + line for line in buf.getvalue().splitlines()))
    log(f"{tag}: rc {rc}, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train CLI {extra} exited {rc}")
    with open(log_path) as fh:
        losses = [json.loads(line)["loss"] for line in fh]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"train CLI {extra} logged {losses}, expected {TRAIN_STEPS} finite losses")
    return launches, losses


def phase_train_cli(workdir: str, extra=(), kernels=("ln_qkv_attn", *TRAIN_KERNELS)) -> dict:
    """Phases 8 and 12: 12 launches per step of each of ``kernels``, none of
    any other.  -> launch counts of the run."""
    launches, _ = _train_cli(workdir, list(extra))
    want = {name: 0 for name in launches}
    want.update({name: 12 * TRAIN_STEPS for name in kernels})
    if launches != want:
        raise RuntimeError(f"expected {want} kernel launches over {TRAIN_STEPS} steps, "
                           f"got {launches}")
    return launches


def _paths(tree, prefix=""):
    """(leaf path, tensor) of a nested params dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _grads(cfg, tree, x, y, ops, compute_dtype, dev, rng_seed=None):
    """-> (loss, {leaf path: grad}) of one cross-entropy backward; with
    ``rng_seed``, dropout and drop-path draw from a generator of that seed."""
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    params = trainer.as_trainable(tree, dev, torch.float32)
    ops = get_ops(ops) if isinstance(ops, str) else ops
    loss_fn = trainer._make_loss_fn(cfg, ops, False, compute_dtype)
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    loss = loss_fn(params, x, y, rng)
    loss.backward()
    return loss.item(), {path: t.grad for path, t in _paths(params)}


def _worst_leaf(got: dict, want: dict) -> tuple:
    """(worst ratio of max|d| to 1e-3 x max(1, max|g|), its leaf)."""
    worst, worst_leaf = 0.0, None
    for leaf, g in want.items():
        r = (got[leaf] - g).abs().max().item() / (1e-3 * max(1.0, g.abs().max().item()))
        if r > worst:
            worst, worst_leaf = r, leaf
    return worst, worst_leaf


def phase_train_correctness(dev: torch.device) -> None:
    """Phase 9: fused_train vs eager gradients (fp32, every leaf), bf16 mixed
    vs fp32 loss, and memorization through the trainer's step."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg = VIT_B_16
    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    lf, gf = _grads(cfg, tree, x, y, "fused_train", None, dev)
    le, ge = _grads(cfg, tree, x, y, "eager", None, dev)
    worst, worst_leaf = _worst_leaf(gf, ge)
    log(f"train grads fp32 fused_train vs eager autograd (card, TF32 off), B/16, 4 images: "
        f"loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at {worst:.3g} of "
        f"its bound (bound 1e-3 x max(1, max|g|), the JAX package's oracle bar)")
    if worst > 1.0 or set(gf) != set(ge) or not np.isfinite(lf):
        raise RuntimeError("fused_train gradients outside 1e-3 of eager autograd")
    del gf, ge
    lb, _ = _grads(cfg, tree, x, y, "fused_train", torch.bfloat16, dev)
    log(f"train loss bf16 mixed vs fp32 fused_train: {lb:.6g} vs {lf:.6g}, |d|={abs(lb - lf):.6g} "
        f"(tol 2e-2, the reference's bf16 spread)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("bf16 mixed-precision loss outside 2e-2 of fp32")

    # memorization (tests/test_convergence.py): 32 images, classes i % 11.
    # The tiny-config test's AdamW 3e-3 is too hot at B/16 width: there
    # eager and fused_train alike (same losses to 3 decimals) stall at 0.66
    # top-1 after 40 steps; 3e-4 memorizes within 20 (PERF.md).  A head
    # alone could memorize 32 images, so every leaf must also have moved by
    # at least one step's worth (an AdamW step moves an element by up to
    # ~lr; weight decay alone moves it by lr * 1e-4 * |p|).
    cfg11 = dataclasses.replace(cfg, num_classes=11)
    rng = np.random.default_rng(0)
    xm = torch.from_numpy(rng.normal(size=(32, 3, cfg.image_size, cfg.image_size))
                          .astype(np.float32)).to(dev)
    ym = torch.arange(32, device=dev) % 11
    params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg11), dev)
    opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=MEMORIZE_LR, weight_decay=1e-4)
    ops = get_ops("fused_train")
    step = trainer.make_train_step(cfg11, opt, ops, remat=False, compute_dtype=torch.bfloat16)
    start = {path: t.detach().clone() for path, t in _paths(params)}
    best, losses = 0.0, []
    for i in range(40):
        losses.append(float(step(params, xm, ym)))
        if (i + 1) % 10 == 0:
            with torch.no_grad():
                logits = vit.forward(vit.cast_params(params, torch.bfloat16),
                                     xm.to(torch.bfloat16), cfg11, ops)
            best = max(best, (logits.argmax(-1) == ym).float().mean().item())
            if best >= 0.95:
                break
    moved = {path: (t.detach() - start[path]).abs().max().item() for path, t in _paths(params)}
    least = min(moved, key=moved.get)
    log(f"memorization B/16, 32 images, 11 classes, AdamW {MEMORIZE_LR:g}, bf16 mixed: train top-1 "
        f"{best:.6g} after {len(losses)} steps (gate 0.95); losses {[round(v, 4) for v in losses]}; "
        f"least-moved leaf {least}: max|d|={moved[least]:.6g} (gate >= lr)")
    if not (best >= 0.95 and np.isfinite(losses).all()):
        raise RuntimeError("fused_train did not memorize 32 images")
    if not moved[least] >= MEMORIZE_LR:
        raise RuntimeError(f"memorization left {least} (nearly) unchanged: its gradient is lost")


def phase_reg_correctness(dev: torch.device) -> None:
    """Phase 13: the regularized fused_train gradients (fp32, every leaf)
    against autograd through ``train_block_reference_2d`` — the same model
    with the kernels' block replaced by its plain twin, the same seeds, so
    the same masks — and the bf16 mixed loss against fp32."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.ops import trainable
    from vit_tpu_torch.ops.dispatch import get_ops

    cfg = dataclasses.replace(VIT_B_16, dropout=REG_P, drop_path=REG_P)
    fused = get_ops("fused_train")
    twin = dataclasses.replace(fused, name="fused_train_twin",
                               encoder_block_train=trainable.train_block_reference_2d)
    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    lf, gf = _grads(cfg, tree, x, y, fused, None, dev, rng_seed=5)
    lr_, gr = _grads(cfg, tree, x, y, twin, None, dev, rng_seed=5)
    worst, worst_leaf = _worst_leaf(gf, gr)
    log(f"regularized train grads fp32 fused_train vs autograd through the block's plain twin "
        f"(dropout {REG_P}, drop-path {REG_P}, same seeds), B/16, 4 images: loss {lf:.6g} vs "
        f"{lr_:.6g}; {len(gr)} leaves, worst {worst_leaf} at {worst:.3g} of its bound "
        f"(1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(gf) != set(gr) or not np.isfinite(lf):
        raise RuntimeError("regularized fused_train gradients outside 1e-3 of the twin's autograd")
    del gf, gr
    lb, _ = _grads(cfg, tree, x, y, fused, torch.bfloat16, dev, rng_seed=5)
    log(f"regularized train loss bf16 mixed vs fp32: {lb:.6g} vs {lf:.6g}, |d|={abs(lb - lf):.6g} "
        f"(tol 2e-2)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("regularized bf16 mixed-precision loss outside 2e-2 of fp32")


def _train_rates(dev, card: str, runs: dict, phase: str, base=None, b: int = 64) -> dict:
    """Train img/s at ``base`` (default B/16 @224) batch ``b`` bf16 mixed
    (no remat) of each run ``label: (ops, regularized[, tome_r[,
    optimizer]])`` (optimizer 'adamw', torch's, or 'fused_adamw', K20),
    timed in turns, and the peak device memory of each alone on the card."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    base = base or VIT_B_16
    x = torch.from_numpy(synth_images(b, base, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % base.num_classes

    def make(ops, regularized, tome_r=0, optimizer="adamw"):
        cfg = (dataclasses.replace(base, dropout=REG_P, drop_path=REG_P) if regularized
               else base)
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        make_opt = trainer.FusedAdamW if optimizer == "fused_adamw" else torch.optim.AdamW
        opt = make_opt(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_train_step(cfg, opt, get_ops(ops), remat=False,
                                       compute_dtype=torch.bfloat16, use_dropout=regularized,
                                       rng=torch.Generator().manual_seed(0),
                                       forward_fn=_tome_train_forward(cfg, ops, tome_r))
        return lambda: float(step(params, x, y))

    peak = {}
    for label, spec in runs.items():  # alone on the card, for its peak
        run = make(*spec)
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        del run
        torch.cuda.empty_cache()
    steps = {label: make(*spec) for label, spec in runs.items()}
    for run in steps.values():  # warm up
        run()
        run()
    times = {label: [] for label in steps}
    order = list(steps)
    for _ in range(4):
        for label in order + order[::-1]:
            t0 = time.perf_counter()
            steps[label]()  # float(loss) waits for the device
            times[label].append(time.perf_counter() - t0)
    rates = {label: b / statistics.median(t) for label, t in times.items()}
    for label, rate in rates.items():
        log(f"{phase} {label} {base.name} batch {b} bf16 mixed: {rate:.6g} img/s "
            f"(median of {len(times[label])}, step {statistics.median(times[label]) * 1e3:.6g} ms); "
            f"peak device memory {peak[label]:.6g} GiB; {card}")
    return rates, peak


def phase_train_throughput(dev: torch.device, card: str) -> dict:
    """Phase 10: fused_train and eager, unregularized."""
    return _train_rates(dev, card, {"fused_train": ("fused_train", False),
                                    "eager": ("eager", False)}, "train throughput")[0]


def phase_reg_throughput(dev: torch.device, card: str) -> dict:
    """Phase 14: regularized fused_train, unregularized fused_train and
    regularized eager; the regularized kernels store no mask, so their
    step's peak memory stays within 1% of the unregularized one's."""
    rates, peak = _train_rates(dev, card, {
        "fused_train regularized": ("fused_train", True),
        "fused_train": ("fused_train", False),
        "eager regularized": ("eager", True),
    }, "regularized train throughput")
    ratio = peak["fused_train regularized"] / peak["fused_train"]
    log(f"peak memory regularized / unregularized fused_train: {ratio:.6g} (gate <= 1.01)")
    if not ratio <= 1.01:
        raise RuntimeError("the regularized step's peak memory exceeds the unregularized one's by > 1%")
    return rates


def phase_long_inference(dev: torch.device) -> dict:
    """Phase 16: the long classify path through ``InferenceEngine``.
    -> launch counts of one bf16 forward of 16 images."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    params = synth_params(cfg, 0)
    images = synth_images(16, cfg, seed=5)
    fused16 = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=16)
    wrappers = _reset_counts()
    l16 = fused16.logits(images).cpu().numpy()
    torch.cuda.synchronize()
    launches = _expect_counts(
        wrappers, {"layer_norm": 13, "flash_attention_fwd": 12, "out_ln_mlp_residual": 12},
        f"long classify {cfg.name} (T {cfg.seq_len}) batch 16 bf16 fused, one forward")
    del fused16
    if l16.shape != (16, cfg.num_classes) or not np.isfinite(l16).all():
        raise RuntimeError(f"long bf16 logits: shape {l16.shape} or non-finite")

    fused32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=1)
    f32 = fused32.logits(images).cpu().numpy()
    del fused32
    eager32 = InferenceEngine(cfg, params, "float32", "eager", dev, batch_pad=1)
    e32 = eager32.logits(images[:4]).cpu().numpy()
    del eager32
    torch.cuda.empty_cache()
    dev_eager = float(np.abs(f32[:4] - e32).max())
    log(f"long fp32 fused vs fp32 eager (card, TF32 off), {cfg.name}, 4 images: "
        f"max|d logit|={dev_eager:.6g} (tol 1e-3)")
    if not dev_eager <= 1e-3:
        raise RuntimeError("long fp32 fused logits outside 1e-3 of the eager path")
    _comparator_rule("long bf16 fused vs fp32 fused", _probs(l16), _probs(f32))
    return launches


def phase_long_train(dev: torch.device) -> dict:
    """Phase 17: the trainer's step on the long path, its launches, and
    its gradients against eager autograd.  -> launch counts of one step."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    b = 16
    x = torch.from_numpy(synth_images(b, cfg, seed=6)).to(dev)
    y = torch.arange(b, device=dev) * 13 % cfg.num_classes
    params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
    opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
    step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                   compute_dtype=torch.bfloat16)
    step(params, x, y)  # warm up
    torch.cuda.synchronize()
    wrappers = _reset_counts()
    loss = float(step(params, x, y))
    launches = _expect_counts(
        wrappers, {name: 12 for name in ("flash_attention_fwd", "flash_attention_bwd",
                                         "out_residual", "ln_mlp_residual",
                                         "ln_mlp_residual_bwd", "out_residual_bwd")},
        f"long train {cfg.name} (T {cfg.seq_len}) batch {b} bf16 mixed fused_train, one step")
    if not np.isfinite(loss):
        raise RuntimeError(f"long train step loss {loss}")
    del params, opt, step
    torch.cuda.empty_cache()

    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x2 = torch.from_numpy(synth_images(2, cfg, seed=7)).to(dev)
    y2 = torch.tensor([3, 141], device=dev) % cfg.num_classes
    lf, gf = _grads(cfg, tree, x2, y2, "fused_train", None, dev)
    le, ge = _grads(cfg, tree, x2, y2, "eager", None, dev)
    worst, worst_leaf = _worst_leaf(gf, ge)
    log(f"long train grads fp32 fused_train vs eager autograd (card, TF32 off), {cfg.name}, "
        f"2 images: loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at "
        f"{worst:.3g} of its bound (1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(gf) != set(ge) or not np.isfinite(lf):
        raise RuntimeError("long fused_train gradients outside 1e-3 of eager autograd")
    del gf, ge
    lb, _ = _grads(cfg, tree, x2, y2, "fused_train", torch.bfloat16, dev)
    log(f"long train loss bf16 mixed vs fp32 fused_train: {lb:.6g} vs {lf:.6g}, "
        f"|d|={abs(lb - lf):.6g} (tol 2e-2)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("long bf16 mixed-precision loss outside 2e-2 of fp32")
    return launches


def phase_long_throughput(dev: torch.device, card: str) -> None:
    """Phase 18: long classify img/s and peak memory (fused vs eager, batch
    16 bf16, in turns), then the long train step's (fused_train vs eager)."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    x = torch.from_numpy(synth_images(16, cfg, seed=8)).to(dev, torch.bfloat16)
    _inference_rates(cfg, synth_params(cfg, 0), x, ("fused", "eager"), dev, card,
                     "long classify throughput", 4)
    torch.cuda.empty_cache()
    _train_rates(dev, card, {"fused_train": ("fused_train", False), "eager": ("eager", False)},
                 "long train throughput", base=cfg, b=16)


def phase_switch(dev: torch.device, card: str) -> None:
    """Phase 19: the K1 + K2 block against the long block (K3 + QKV GEMM +
    K13 + K2) at T = 577 and 1,025, B/16 width, batch 16, bf16, in turns.
    The switch stays at 1,024, so that both packages route alike."""
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import out_ln_mlp_residual

    d, h, f = B16["d"], B16["heads"], B16["f"]
    rn = _rand(dev, 9)
    dt = torch.bfloat16
    blk = {"ln1_scale": rn(d, scale=0.2, shift=1.0, dtype=dt), "ln1_bias": rn(d, scale=0.2, dtype=dt),
           "wqkv": rn(d, 3 * d, scale=d ** -0.5, dtype=dt), "bqkv": rn(3 * d, scale=0.1, dtype=dt),
           "wo": rn(d, d, scale=d ** -0.5, dtype=dt), "bo": rn(d, scale=0.1, dtype=dt),
           "ln2_scale": rn(d, scale=0.2, shift=1.0, dtype=dt), "ln2_bias": rn(d, scale=0.2, dtype=dt),
           "w1": rn(d, f, scale=d ** -0.5, dtype=dt), "b1": rn(f, scale=0.1, dtype=dt),
           "w2": rn(f, d, scale=f ** -0.5, dtype=dt), "b2": rn(d, scale=0.1, dtype=dt)}

    def k1k2(x, t):  # what fused_encoder_block runs up to the switch
        ctx = ln_qkv_attn(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"], h, t,
                          1e-6)
        return out_ln_mlp_residual(ctx, x, blk["wo"], blk["bo"], blk["ln2_scale"],
                                   blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                   1e-6)

    for t in SWITCH_T:
        x = rn(16 * t, d, scale=2.0, dtype=dt)
        short = lambda: k1k2(x, t)  # noqa: E731
        long = lambda: fused_block._long_seq_block(x, blk, h, t, 1e-6, "exact")  # noqa: E731
        err = (short().float() - long().float()).abs().max().item()
        ms = {"K1+K2": [], "K3+GEMM+K13+K2": []}
        for _ in range(3):
            for label, fn in (("K1+K2", short), ("K3+GEMM+K13+K2", long),
                              ("K3+GEMM+K13+K2", long), ("K1+K2", short)):
                ms[label].append(cuda_ms(fn, warmup=1, iters=5))
        a, b = (statistics.median(v) for v in ms.values())
        log(f"switch at T {t}, B/16 batch 16 bf16: K1+K2 block {a:.6g} ms, K3+GEMM+K13+K2 "
            f"block {b:.6g} ms (ratio {b / a:.6g}); outputs max|d|={err:.6g}; {card}")


def quant_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K15-K17 at B/16 shapes (batch 100 and 3) and
    for K15's stages 1-2 at @512 shapes (batch 16 and 3).  A case holds the
    wrapper, its ``_stages`` function, its plain twin, the stage checks
    (``eval/quant_stages.py``), and the int8 operations and FLOPs its
    function needs."""
    from vit_tpu_torch.eval import quant_stages as qs
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as k17
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual_q8 as k16

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    t512 = (LONG_IMAGE // 16) ** 2 + 1
    rn = _rand(dev, 10)
    cases = {name: [] for name in QUANT_KERNELS}

    def add(name, mod, dtype, b, rows, args, int8_ops, flops, out="out", plain=None, check=None):
        cases[name].append(dict(
            tag=_tag(dtype, b, rows), dtype=dtype, batch=b, args=args, out=out,
            kernel=getattr(mod, name), stages=getattr(mod, f"_{name}_stages"),
            plain=plain or getattr(mod, f"{name}_plain"), int8_ops=int8_ops, flops=flops,
            check=check or getattr(qs, f"check_{name}")))

    # the stages' twin returns (hq, hs, qkv); its checks take K15's operands
    qkv_plain = lambda *a: k15.ln_qkv_q8_plain(*a)[2]  # noqa: E731
    qkv_check = lambda st, end, *a: qs.check_ln_qkv_attn_q8(  # noqa: E731
        st, end, *a[:6], None, None, a[6])

    for dtype in (torch.bfloat16, torch.float32):
        s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        wq, ws = quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5))
        bqkv = rn(3 * d, scale=0.1, dtype=dtype)
        wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        (w1q, w1s), bb1 = quant.quantize_weight(rn(d, f, scale=d ** -0.5)), rn(f, scale=0.1, dtype=dtype)
        (w2q, w2s), bb2 = quant.quantize_weight(rn(f, d, scale=f ** -0.5)), rn(d, scale=0.1, dtype=dtype)
        mlp = (s1, b1n, w1q, w1s, bb1, w2q, w2s, bb2, 1e-6, "exact")
        for b in BATCHES:
            rows = b * t
            x = rn(rows, d, scale=2.0, dtype=dtype)
            a15 = (x, s1, b1n, wq, ws, bqkv, h, t, 1e-6)
            ctx = k15.ln_qkv_attn_q8_plain(*a15)
            add("ln_qkv_attn_q8", k15, dtype, b, rows, a15, 2 * rows * d * 3 * d,
                4 * b * t * t * d, out="ctx")
            add("out_ln_mlp_residual_q8", k16, dtype, b, rows, (ctx, x, wo, bo, *mlp),
                4 * rows * d * f, 2 * rows * d * d)
            add("ln_mlp_residual_q8", k17, dtype, b, rows, (x, *mlp), 4 * rows * d * f, 0)
        for b in LONG_BATCHES:
            rows = b * t512
            x = rn(rows, d, scale=2.0, dtype=dtype)
            add("ln_qkv_q8", k15, dtype, b, rows, (x, s1, b1n, wq, ws, bqkv, 1e-6),
                2 * rows * d * 3 * d, 0, out="qkv", plain=qkv_plain, check=qkv_check)
    return cases


def phase_quant_kernels(cases: dict, labels: dict = QUANT_KERNELS) -> dict:
    """Phases 20, 25 and 26: each W8A8 kernel's stages against its twin's by
    the two checks, then the timings.  -> {kernel: summary at bf16, the
    path's batch}; ``max_abs_err`` is the output's deviation from the whole
    twin's (moved codes included)."""
    summary = {}
    for name, kcases in cases.items():
        for c in kcases:
            args, dtype = c["args"], c["dtype"]
            st, end = c["stages"](*args), c["plain"](*args)
            torch.cuda.synchronize()
            report = c["check"](st, end, *args)
            err = (st[c["out"]].float() - end.float()).abs().max().item()
            nbytes = _nbytes([a for a in args if torch.is_tensor(a)]) + _nbytes([st[c["out"]]])
            del st, end
            ms, plain_ms = cuda_ms(lambda: c["kernel"](*args)), cuda_ms(lambda: c["plain"](*args))
            bound_ms, bound_by = bound(c["flops"], nbytes, dtype, c["int8_ops"])
            log(f"{labels[name][0]} {name} {c['tag']}: stages "
                + ", ".join(f"{k} {v:.3g}" for k, v in report.items())
                + f"; vs the whole twin max|d|={err:.6g}; kernel {ms:.6g} ms, plain "
                f"{plain_ms:.6g} ms, library none, bound {bound_ms:.6g} ms ({bound_by})")
            if c.get("summary", dtype == torch.bfloat16 and c["batch"] == kcases[0]["batch"]):
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return summary


# (what, K, N) of the main path's bf16 GEMMs at ViT-B/16 @224 batch 100
# (what, M, K, N, trans_a, trans_b, splits): the classify path's four GEMMs
# at B/16 batch 100 (M 19,700), then the MLP backward's four at @512 batch
# 16 (16,400 rows; K8's and K12b's): dY W2ᵀ and du_c W1ᵀ with the [in, out]
# weight read K-major, dW1 = h2ᵀ du_c and dW2 = gᵀ dY with the activation
# read MN-major and the rows split as the kernels split them
GEMM_CORE_SHAPES = (("QKV", 19700, 768, 2304, False, False, 1),
                    ("out_proj", 19700, 768, 768, False, False, 1),
                    ("FC1", 19700, 768, 3072, False, False, 1),
                    ("FC2", 19700, 3072, 768, False, False, 1),
                    ("dY W2^T", 16400, 768, 3072, False, True, 1),
                    ("du W1^T", 16400, 3072, 768, False, True, 1),
                    ("dW1 h2^T du", 768, 16400, 3072, True, False, 0),
                    ("dW2 g^T dY", 3072, 16400, 768, True, False, 0))


def phase_gemm_core(dev: torch.device, card: str) -> None:
    """Phase 3's GEMM lines: the bf16 core of K1, K2, K7/K12a and K8/K12b
    alone at GEMM_CORE_SHAPES, in each operand form, its fp32 sums within 2^-14 of
    the largest |value| of fp32 ``torch.matmul`` on the same bf16 operands
    (the tensor cores' accumulation truncates once per k16 step: up to
    K / 16 fp32 ulps of a split's depth), timed beside one bf16
    ``torch.matmul`` on the same operands, transposed views as they lie (a
    yardstick; the port never calls it)."""
    from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16, gemm_bf16_plain

    gen = torch.Generator(device=dev).manual_seed(12)
    for what, m, k, n, trans_a, trans_b, splits in GEMM_CORE_SHAPES:
        a = torch.randn(*((k, m) if trans_a else (m, k)), generator=gen, device=dev).bfloat16()
        b = (torch.randn(*((n, k) if trans_b else (k, n)), generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        a_op, b_op = (a.T if trans_a else a), (b.T if trans_b else b)
        got, want = gemm_bf16(a, b, trans_a, trans_b, splits), gemm_bf16_plain(a, b, trans_a,
                                                                                trans_b)
        err = (got - want).abs().max().item()
        tol = 2.0 ** -14 * max(1.0, want.abs().max().item())
        if not err <= tol:
            raise RuntimeError(f"bf16 GEMM core {what} ({m} x {k} x {n}): max|d|={err:.6g} > "
                               f"tol {tol:.6g} against fp32 torch.matmul")
        del got, want
        ms = cuda_ms(lambda: gemm_bf16(a, b, trans_a, trans_b, splits))
        lib = cuda_ms(lambda: a_op @ b_op)
        flop = 2 * m * k * n
        bound_ms, bound_by = bound(flop, _nbytes((a, b)) + 4 * m * n, torch.bfloat16)
        form = (" (a read MN-major)" * trans_a + " (b read K-major)" * trans_b
                + " (rows split)" * (splits != 1))
        log(f"bf16 GEMM core {what}{form} {m} x {k} x {n}: max|d|={err:.6g} (tol {tol:.6g}); "
            f"{ms:.6g} ms ({flop / ms / 1e9:.6g} TFLOP/s), library_ms torch.matmul bf16 "
            f"{lib:.6g} ms ({flop / lib / 1e9:.6g} TFLOP/s), bound {bound_ms:.6g} ms "
            f"({bound_by}, {bound_ms / ms:.1%} of the core's); {card}")


# (what, rows, M, N): the weight gradients at their depths: dW1 = h2ᵀ du
# and dW2 = gᵀ dY at @512 batch 16 (K8) and batch 64 at ToMe's first merged
# layer, T 171 (K12b); dW_o = ctxᵀ dx1 at @224 batch 64 (K7, K12a); and the
# split counts timed beside the kernels' own rule (0)
WGRAD_CASES = tuple((what, rows, m, n) for rows in (16 * 1025, 64 * 171)
                    for what, m, n in (("dW1", 768, 3072), ("dW2", 3072, 768),
                                       ("dW_o", 768, 768))
                    ) + (("dW_o", 64 * 197, 768, 768),)
WGRAD_SPLITS = (0, 1, 2, 3, 5, 7, 9, 11, 22)


def phase_wgrad_splits(dev: torch.device, card: str) -> None:
    """Phase 3's split lines: the core's split-K weight gradients of
    WGRAD_CASES (A read MN-major, the rows its depth), each timed at every
    split count of WGRAD_SPLITS, partial sums included, each within phase
    3's 2^-14 of fp32 ``torch.matmul``, with the split count the kernels'
    rule (``gemm_mma.cuh:mma_wgrad_split``, split 0) picks: its partials'
    size over one fp32 (m, n) product."""
    from vit_tpu_torch.ops.kernels import _build
    from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16, gemm_bf16_plain

    gen = torch.Generator(device=dev).manual_seed(13)
    for what, rows, m, n in WGRAD_CASES:
        a = torch.randn(rows, m, generator=gen, device=dev).bfloat16()
        b = (torch.randn(rows, n, generator=gen, device=dev) * rows ** -0.5).bfloat16()
        want = gemm_bf16_plain(a, b, True)
        tol = 2.0 ** -14 * max(1.0, want.abs().max().item())
        times = []
        for splits in WGRAD_SPLITS:
            err = (gemm_bf16(a, b, True, False, splits) - want).abs().max().item()
            if not err <= tol:
                raise RuntimeError(f"bf16 GEMM core {what} rows {rows} splits {splits}: "
                                   f"max|d|={err:.6g} > tol {tol:.6g}")
            times.append(cuda_ms(lambda: gemm_bf16(a, b, True, False, splits)))
        picks = max(1, _build.load_library().vt_gemm_bf16_workspace(m, n, rows, 0) // (4 * m * n))
        log(f"bf16 GEMM core {what} {m} x {rows} x {n} (a read MN-major; the rule picks "
            f"{picks}) by split count: "
            + ", ".join(f"{'rule' if sp == 0 else sp} {t:.6g} ms"
                        for sp, t in zip(WGRAD_SPLITS, times))
            + f"; {card}")
        del a, b, want


def phase_int8_gemm(dev: torch.device, card: str) -> None:
    """The int8 GEMM cores alone at the W8A8 path's three GEMM shapes (batch
    100): the TMA + ``wgmma`` core of the bf16 K15-K17 (B read K-major,
    from the copy their transpose kernel makes) beside the WMMA core of
    K18a/b, K19 and the fp32 K15-K17, each exact against the float64
    reference, timed beside ``torch._int_mm`` (a yardstick; the port never
    calls it), whose int32 sums dequantized the reference's way must equal
    them too."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import gemm_q8_dequant
    from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual_q8 import gemm_q8_mma_dequant

    d, f, rows = B16["d"], B16["f"], 100 * B16["t"]
    gen = torch.Generator(device=dev).manual_seed(11)
    for what, (m, k, n) in (("QKV", (rows, d, 3 * d)), ("FC1", (rows, d, f)), ("FC2", (rows, f, d))):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        sa, sb = torch.rand(m, generator=gen, device=dev) + 0.1, torch.rand(n, generator=gen, device=dev) + 0.1
        bt = kmajor_q8(b)
        want = quant.int8_matmul_reference(a, sa, b, sb)
        for core, got in (("WMMA", gemm_q8_dequant(a, sa, b, sb)),
                          ("TMA + wgmma", gemm_q8_mma_dequant(a, sa, bt, sb))):
            if not torch.equal(got, want):
                raise RuntimeError(f"int8 GEMM core ({core}) {what} ({m} x {k} x {n}) is not exact")
        del got, want
        ops = 2 * m * k * n
        ms = cuda_ms(lambda: gemm_q8_dequant(a, sa, b, sb))
        ms_mma = cuda_ms(lambda: gemm_q8_mma_dequant(a, sa, bt, sb))
        ms_tr = cuda_ms(lambda: kmajor_q8(b))
        try:  # a private torch function: its absence or refusal fails nothing here
            sums = torch._int_mm(a, b)
            lib = cuda_ms(lambda: torch._int_mm(a, b))
        except (AttributeError, RuntimeError) as e:
            yardstick = f"unavailable ({type(e).__name__})"
        else:
            if not torch.equal((sums.float() * sa[:, None]) * sb[None, :],
                               gemm_q8_mma_dequant(a, sa, bt, sb)):
                raise RuntimeError(f"int8 GEMM core {what}: differs from torch._int_mm's sums")
            yardstick = f"{lib:.6g} ms ({ops / lib / 1e9:.6g} TOP/s), the same bits"
            del sums
        bound_ms, _ = bound(0, _nbytes((a, b, sa, sb)) + 4 * m * n, torch.bfloat16, ops)
        log(f"int8 GEMM core {what} {m} x {k} x {n}: exact; TMA + wgmma {ms_mma:.6g} ms "
            f"({ops / ms_mma / 1e9:.6g} TOP/s, {bound_ms / ms_mma:.1%} of bound; K-major copy "
            f"of B {ms_tr:.6g} ms), WMMA {ms:.6g} ms ({ops / ms / 1e9:.6g} TOP/s), "
            f"torch._int_mm {yardstick}; {card}")


def _quant_twin_ops():
    """The ``quant`` op table with every kernel replaced by its plain twin."""
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.ops.kernels.layer_norm import layer_norm_plain
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8_plain
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual_q8 import out_ln_mlp_residual_q8_plain

    def block(x2d, blk, num_heads, seq_len, eps, gelu_variant="exact"):
        ctx = ln_qkv_attn_q8_plain(x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                                   blk["wqkv_scale"], blk["bqkv"], num_heads, seq_len, eps)
        return out_ln_mlp_residual_q8_plain(
            ctx, x2d, blk["wo"], blk["bo"], blk["ln2_scale"], blk["ln2_bias"], blk["w1"],
            blk["w1_scale"], blk["b1"], blk["w2"], blk["w2_scale"], blk["b2"], eps, gelu_variant)

    return dataclasses.replace(get_ops("quant"), name="quant_twin", layer_norm=layer_norm_plain,
                               encoder_block=block)


def phase_quant_correctness(params, images: np.ndarray, dev: torch.device) -> None:
    """Phase 22: bf16 quant vs fp32 fused (comparator rule: labels survive
    int8), and fp32 quant vs the same model through the kernels' twins."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    fused32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=1)
    f32 = fused32.logits(images).cpu().numpy()
    del fused32
    quant16 = InferenceEngine(cfg, params, "bfloat16", "quant", dev, batch_pad=1)
    q16 = quant16.logits(images).cpu().numpy()
    del quant16
    if q16.shape != (len(images), cfg.num_classes) or not np.isfinite(q16).all():
        raise RuntimeError(f"bf16 quant logits: shape {q16.shape} or non-finite")
    log(f"bf16 quant vs fp32 fused, {len(images)} images: max|d logit|="
        f"{float(np.abs(q16 - f32).max()):.6g} (int8 noise over 12 layers; not gated)")
    _comparator_rule("bf16 quant vs fp32 fused", _probs(q16), _probs(f32))

    quant32 = InferenceEngine(cfg, params, "float32", "quant", dev, batch_pad=1)
    x = torch.from_numpy(images[:8]).to(dev)
    k32 = quant32.logits(x)
    with torch.inference_mode():
        t32 = vit.forward(quant32.params, x, cfg, _quant_twin_ops())
    k32, t32 = k32.cpu().numpy(), t32.cpu().numpy()
    err, noise = float(np.abs(k32 - t32).max()), float(np.abs(k32 - f32[:8]).max())
    log(f"fp32 quant kernels vs their twins (card), 8 images: max|d logit|={err:.6g} (tol "
        f"{noise:.6g}, what int8 itself moves these logits against fp32 fused)")
    if not err <= noise:
        raise RuntimeError("fp32 quant logits further from the twins' model than from fp32")
    _comparator_rule("fp32 quant kernels vs their twins", _probs(k32), _probs(t32))


def phase_quant_long(dev: torch.device) -> dict:
    """Phase 23: the long W8A8 path through ``InferenceEngine``.  -> launch
    counts of one bf16 forward of 16 images."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    params = synth_params(cfg, 0)
    images = synth_images(16, cfg, seed=5)
    quant16 = InferenceEngine(cfg, params, "bfloat16", "quant", dev, batch_pad=16)
    wrappers = _reset_counts()
    l16 = quant16.logits(images).cpu().numpy()
    torch.cuda.synchronize()
    launches = _expect_counts(
        wrappers, {"ln_qkv_q8": 12, "flash_attention_fwd": 12, "out_ln_mlp_residual_q8": 12,
                   "layer_norm": 1},
        f"long classify {cfg.name} (T {cfg.seq_len}) batch 16 bf16 quant, one forward")
    del quant16
    if l16.shape != (16, cfg.num_classes) or not np.isfinite(l16).all():
        raise RuntimeError(f"long bf16 quant logits: shape {l16.shape} or non-finite")
    quant32 = InferenceEngine(cfg, params, "float32", "quant", dev, batch_pad=1)
    q32 = quant32.logits(images).cpu().numpy()
    del quant32
    torch.cuda.empty_cache()
    _comparator_rule("long bf16 quant vs fp32 quant", _probs(l16), _probs(q32))
    return launches


def phase_quant_throughput(params, images: np.ndarray, dev: torch.device, card: str) -> None:
    """Phase 24: quant, fused and eager in turns, bf16, at @224 batch 100
    and @512 batch 16, with the peak device memory of one forward of each."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images

    ops = ("quant", "fused", "eager")
    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    _inference_rates(VIT_B_16, params, x, ops, dev, card, "quant throughput", 4)
    torch.cuda.empty_cache()
    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    x = torch.from_numpy(synth_images(16, cfg, seed=8)).to(dev, torch.bfloat16)
    _inference_rates(cfg, synth_params(cfg, 0), x, ops, dev, card, "quant long throughput", 4)


# -- token merging (ToMe) and head width 80 -----------------------------------


def _tome_train_forward(cfg, ops: str, tome_r: int):
    """The trainer's ``forward_fn`` for merged-token training at ``tome_r``
    on the train CLI's schedule (None at 0: the plain forward)."""
    if not tome_r:
        return None
    from vit_tpu_torch.models import tome

    impl = tome.forward_train if ops == "fused_train" else tome.forward_eager
    counts = tome.schedule(cfg, tome_r, tome.TRAIN_MERGE_CHUNK)
    return lambda p, x, rng: impl(p, x, cfg, tome_r, counts=counts, dropout_rng=rng)


def _merged_counts(r: int, chunk: int) -> list:
    """The token counts B/16's layers run at under ToMe r, in order."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.models import tome

    t, out = VIT_B_16.seq_len, []
    for rl in tome.schedule(VIT_B_16, r, chunk):
        out.append(t)
        t -= rl
    return out


def _log_size(dev, b: int, t: int) -> torch.Tensor:
    """log of random token sizes 1-5, (b, t) fp32: a merged layer's bias."""
    g = torch.Generator(device=dev).manual_seed(12)
    return torch.log(torch.randint(1, 6, (b, t), generator=g, device=dev).float())


def tome_kernel_cases(dev: torch.device):
    """-> ({kernel: [case]}, labels) for phase 25 at B/16 width on merged
    token counts: K1 with both hooks at batch 100 (T 158, the r = 13
    inference schedule's first merged layer) and 3 (T 41, its last); K6
    with log_size and no residual join, K12b and K12c at batch 64 (T 171,
    the training schedule's first merged layer) and 3 (T 41), at dropout
    and drop-path REG_P; K8 (the plain ToMe step's MLP backward) at the
    same counts.  Bounds count the rows a drop-path scale keeps."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    d, h, f = B16["d"], B16["heads"], B16["f"]
    t_inf, t_train = _merged_counts(TOME_R, 3), _merged_counts(TOME_R, 2)
    rn = _rand(dev, 13)
    labels = {"ln_qkv_attn+hooks": ("K1 log_size kmean",), "ln_qkv_attn_bwd+hooks": (
        "K6 log_size dres=None",), **TOME_KERNELS, "ln_mlp_residual_bwd+merged": ("K8 merged",)}
    cases = {name: [] for name in labels}
    hooked_k1 = lambda *a: k1.ln_qkv_attn(*a[:8], log_size=a[8], return_kmean=True)  # noqa: E731
    plain_k1 = lambda *a: k1.ln_qkv_attn_plain(*a[:8], log_size=a[8], return_kmean=True)  # noqa: E731
    hooked_k6 = lambda *a: k6.ln_qkv_attn_bwd(*a[:10], log_size=a[10])  # noqa: E731
    plain_k6 = lambda *a: k6.ln_qkv_attn_bwd_plain(*a[:10], log_size=a[10])  # noqa: E731
    for dtype in (torch.bfloat16, torch.float32):
        s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
        s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        wo = rn(d, d, scale=d ** -0.5, dtype=dtype)
        w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
        w2 = rn(f, d, scale=f ** -0.5, dtype=dtype)
        for b, t in ((100, t_inf[3]), (3, t_inf[-1])):
            rows = b * t
            x = rn(rows, d, scale=2.0, dtype=dtype)
            cases["ln_qkv_attn+hooks"].append(case(
                _tag(dtype, b, rows) + f" T {t}", dtype, b, hooked_k1, plain_k1,
                (x, s1, b1n, wqkv, bqkv, h, t, 1e-6, _log_size(dev, b, t)),
                2 * rows * d * 3 * d + 4 * b * t * t * d))
        for b, t in ((64, t_train[2]), (3, t_train[-1])):
            rows = b * t
            tag = _tag(dtype, b, rows) + f" T {t}"
            x, x1, dy, ctx = (rn(rows, d, scale=sc, dtype=dtype) for sc in (2.0, 2.0, 1.0, 1.0))
            dp_a = drop_path_scale_rows(REG_SEED, 4, b, t, REG_P, device=dev)
            dp_m = drop_path_scale_rows(REG_SEED, 5, b, t, REG_P, device=dev)
            kept_a, kept_m = (int((dp != 0).sum()) for dp in (dp_a, dp_m))
            cases["ln_qkv_attn_bwd+hooks"].append(case(
                tag, dtype, b, hooked_k6, plain_k6,
                (dy, None, x, s1, b1n, wqkv, bqkv, h, t, 1e-6, _log_size(dev, b, t)),
                6 * rows * d * 3 * d + 10 * b * t * t * d))
            cases["ln_mlp_residual_bwd_train"].append(case(
                tag, dtype, b, k12b.ln_mlp_residual_bwd_train, k12b.ln_mlp_residual_bwd_train_plain,
                (dy, x1, s2, b2n, w1, bb1, w2, dp_m, REG_SEED, REG_P, 1e-6, "exact"),
                10 * kept_m * d * f))
            cases["out_residual_bwd_train"].append(case(
                tag, dtype, b, k12c.out_residual_bwd_train, k12c.out_residual_bwd_train_plain,
                (dy, ctx, wo, dp_a, REG_SEED, REG_P), 4 * kept_a * d * d))
            cases["ln_mlp_residual_bwd+merged"].append(case(
                tag, dtype, b, k8.ln_mlp_residual_bwd, k8.ln_mlp_residual_bwd_plain,
                (dy, x1, s2, b2n, w1, bb1, w2, 1e-6, "exact"), 10 * rows * d * f))
    return cases, labels


def tome_quant_cases(dev: torch.device):
    """-> {kernel: [case]} for phase 25's K15 with both hooks at B/16 width,
    batch 100 T 158 and batch 3 T 41, by the W8A8 stage checks (the k-mean
    against the mean key of the kernel's own dequantized QKV, bit for
    bit)."""
    from vit_tpu_torch.eval import quant_stages as qs
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, t_inf = B16["d"], B16["heads"], _merged_counts(TOME_R, 3)
    rn = _rand(dev, 14)
    cases = {"ln_qkv_attn_q8+hooks": []}
    for dtype in (torch.bfloat16, torch.float32):
        s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        wq, ws = quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5))
        bqkv = rn(3 * d, scale=0.1, dtype=dtype)
        for b, t in ((100, t_inf[3]), (3, t_inf[-1])):
            rows = b * t
            args = (rn(rows, d, scale=2.0, dtype=dtype), s1, b1n, wq, ws, bqkv, h, t, 1e-6,
                    _log_size(dev, b, t), True)
            cases["ln_qkv_attn_q8+hooks"].append(dict(
                tag=_tag(dtype, b, rows) + f" T {t}", dtype=dtype, batch=b, args=args, out="ctx",
                kernel=lambda *a: k15.ln_qkv_attn_q8(*a[:9], log_size=a[9], return_kmean=True),
                stages=k15._ln_qkv_attn_q8_stages,
                plain=lambda *a: k15.ln_qkv_attn_q8_plain(*a[:9], log_size=a[9]),
                int8_ops=2 * rows * d * 3 * d, flops=4 * b * t * t * d,
                check=qs.check_ln_qkv_attn_q8))
    return cases


def dh80_cases(dev: torch.device):
    """-> ({kernel: [case]}, labels, {K15: [case]}) for phase 26: head width
    80 at a ViT-H/14-like shape (D 1,280, 16 heads, T 257, batch 8, bf16
    and fp32): K1, K6, K13 and K14 (on strided views of a packed QKV), and
    K15 by the W8A8 stage checks."""
    from vit_tpu_torch.eval import quant_stages as qs
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import flash_attention as k13
    from vit_tpu_torch.ops.kernels import flash_attention_bwd as k14
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, t, b = H14["d"], H14["heads"], H14["t"], H14["batch"]
    dh, rows = d // h, b * t
    rn = _rand(dev, 15)
    labels = {f"{name} dh80": (f"{k} dh80",) for name, k in (
        ("ln_qkv_attn", "K1"), ("ln_qkv_attn_bwd", "K6"), ("flash_attention_fwd", "K13"),
        ("flash_attention_bwd", "K14"), ("ln_qkv_attn_q8", "K15"))}
    cases = {name: [] for name in labels if "q8" not in name}
    q8 = {"ln_qkv_attn_q8 dh80": []}
    for dtype in (torch.bfloat16, torch.float32):
        tag = _tag(dtype, b, rows) + f" T {t} dh {dh}"
        x, dy, dctx = rn(rows, d, scale=2.0, dtype=dtype), rn(rows, d, dtype=dtype), rn(rows, d, dtype=dtype)
        s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
        cases["ln_qkv_attn dh80"].append(case(
            tag, dtype, b, k1.ln_qkv_attn, k1.ln_qkv_attn_plain,
            (x, s1, b1n, wqkv, bqkv, h, t, 1e-6), 2 * rows * d * 3 * d + 4 * b * t * t * d))
        cases["ln_qkv_attn_bwd dh80"].append(case(
            tag, dtype, b, k6.ln_qkv_attn_bwd, k6.ln_qkv_attn_bwd_plain,
            (dctx, dy, x, s1, b1n, wqkv, bqkv, h, t, 1e-6),
            6 * rows * d * 3 * d + 10 * b * t * t * d))
        q, k, v = packed_views(rn(rows, 3 * d, dtype=dtype), b, t, h, 3)
        out, lse = k13.flash_attention_fwd_plain(q, k, v, True)
        cases["flash_attention_fwd dh80"].append(case(
            tag, dtype, b, lambda *a: k13.flash_attention_fwd(*a, return_lse=True),
            lambda *a: k13.flash_attention_fwd_plain(*a, True), (q, k, v), 4 * b * h * t * t * dh))
        cases["flash_attention_bwd dh80"].append(case(
            tag, dtype, b, k14.flash_attention_bwd, k14.flash_attention_bwd_plain,
            (q, k, v, out, lse, rn(b, h, t, dh, dtype=dtype)), 10 * b * h * t * t * dh))
        wq, ws = quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5))
        args = (x, s1, b1n, wq, ws, bqkv, h, t, 1e-6)
        q8["ln_qkv_attn_q8 dh80"].append(dict(
            tag=tag, dtype=dtype, batch=b, args=args, out="ctx", kernel=k15.ln_qkv_attn_q8,
            stages=k15._ln_qkv_attn_q8_stages, plain=k15.ln_qkv_attn_q8_plain,
            int8_ops=2 * rows * d * 3 * d, flops=4 * b * t * t * d,
            check=qs.check_ln_qkv_attn_q8))
    return cases, labels, q8


def phase_tome_correctness(params, images: np.ndarray, dev: torch.device) -> None:
    """Phase 29: (a) fp32 ToMe ``fused`` against ``forward_eager`` on the
    kernel's own matching (``eval/tome_stages.py``): every merge's k-mean
    within 2^-16 of its scale, the logits within 1e-3; (b) bf16 ``fused``
    and bf16 ``quant`` ToMe against fp32 ``fused`` ToMe by the comparator
    rule; (c) fp32 ToMe ``fused_train`` gradients against eager autograd on
    the kernel's own matching, every leaf within 1e-3 of its scale, plain
    and at dropout and drop-path REG_P (the same seeds, so the same masks)."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.eval import tome_stages
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import tome
    from vit_tpu_torch.runtime import trainer
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg, r = VIT_B_16, TOME_R
    p32 = params_from_numpy(params, dev, torch.float32)
    x8 = torch.from_numpy(images[:8]).to(dev)
    rep = tome_stages.check_against_eager(tome.forward_fused, p32, x8, cfg, r, 2.0 ** -16, 1e-3)
    log(f"ToMe r={r} fp32 fused vs eager on the kernel's own matching, 8 images: {rep['merges']} "
        f"merges, k-mean max|d| {rep['kmean']:.6g} of its scale (tol 2^-16), max|d logit|="
        f"{rep['logits']:.6g} (tol 1e-3)")
    del p32
    probs = {}
    for dtype, ops in (("float32", "fused"), ("bfloat16", "fused"), ("bfloat16", "quant")):
        eng = InferenceEngine(cfg, params, dtype, ops, dev, batch_pad=len(images), tome_r=r)
        logits = eng.logits(images).cpu().numpy()
        if logits.shape != (len(images), cfg.num_classes) or not np.isfinite(logits).all():
            raise RuntimeError(f"ToMe {dtype} {ops} logits: shape {logits.shape} or non-finite")
        probs[dtype, ops] = _probs(logits)
        del eng
    _comparator_rule(f"ToMe r={r} bf16 fused vs fp32 fused", probs["bfloat16", "fused"],
                     probs["float32", "fused"])
    _comparator_rule(f"ToMe r={r} bf16 quant vs fp32 fused", probs["bfloat16", "quant"],
                     probs["float32", "fused"])
    torch.cuda.empty_cache()

    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    for regularized in (False, True):
        rcfg = dataclasses.replace(cfg, dropout=REG_P, drop_path=REG_P) if regularized else cfg
        counts = tome.schedule(rcfg, r, tome.TRAIN_MERGE_CHUNK)

        def grads(fn):
            tree = trainer.as_trainable(params_from_numpy(params, "cpu"), dev, torch.float32)
            rng = torch.Generator().manual_seed(5) if regularized else None
            logits, out = fn(tree, rng)
            loss = trainer.cross_entropy_loss(logits, y)
            loss.backward()
            return loss.item(), {path: t.grad for path, t in _paths(tree)}, out

        lf, gf, metrics = grads(lambda p, rng: tome_stages.kernel_metrics(
            tome.forward_train, p, x, rcfg, r, counts=counts, dropout_rng=rng))
        le, ge, _ = grads(lambda p, rng: tome_stages.eager_on_metrics(
            p, x, rcfg, r, metrics, counts=counts, dropout_rng=rng))
        worst, worst_leaf = _worst_leaf(gf, ge)
        what = "regularized " if regularized else ""
        log(f"ToMe r={r} {what}train grads fp32 fused_train vs eager autograd on the kernel's own "
            f"matching, B/16, 4 images: loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst "
            f"{worst_leaf} at {worst:.3g} of its bound (1e-3 x max(1, max|g|))")
        if worst > 1.0 or set(gf) != set(ge) or not np.isfinite(lf):
            raise RuntimeError(f"ToMe {what}fused_train gradients outside 1e-3 of eager autograd")
        del gf, ge
        torch.cuda.empty_cache()


def phase_tome_throughput(params, images: np.ndarray, dev: torch.device, card: str) -> None:
    """Phase 30: classify img/s of ``fused`` and ``quant`` at ToMe r = 0,
    13 and 16 (batch 100 bf16, ``InferenceEngine``), timed in turns with
    the peak device memory of one forward of each; one r = 13 forward of
    each in a profiler trace (device time by kernel); then the train step at
    r = 0 and 13 (batch 64 bf16 mixed, the train schedule), plain and at
    dropout and drop-path REG_P."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.runtime.engine import InferenceEngine

    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    n = x.shape[0]
    engines, peak = {}, {}
    for ops in ("fused", "quant"):
        for r in TOME_RATE_R:
            label = f"{ops} r={r}"
            engines[label] = InferenceEngine(VIT_B_16, params, "bfloat16", ops, dev, batch_pad=n,
                                             tome_r=r)
            engines[label].logits(x)  # warm up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            engines[label].logits(x)
            peak[label] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    order = list(engines)
    times = {label: [] for label in order}
    for _ in range(3):
        for label in order + order[::-1]:
            t0 = time.perf_counter()
            engines[label].logits(x)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    for label, ts in times.items():
        log(f"ToMe throughput {label} vit_b_16 batch {n} bf16: {n / statistics.median(ts):.6g} "
            f"img/s (median of {len(ts)}, forward {statistics.median(ts) * 1e3:.6g} ms); "
            f"activation peak above the params {peak[label]:.6g} GiB; {card}")
    del engines
    # one merge event of the r = 13 forward alone: the matching and the
    # matrix (plain torch, no gradient) and the fp32 merge GEMM
    from vit_tpu_torch.models import tome

    t, r = VIT_B_16.seq_len, 3 * TOME_R
    rn = _rand(dev, 16)
    xm, km = rn(n, t, B16["d"], dtype=torch.bfloat16), rn(n, t, B16["d"] // B16["heads"],
                                                          dtype=torch.bfloat16)
    sizes = torch.ones(n, t, device=dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: tome._merge(xm, km, sizes, r, 1))
        gemm = cuda_ms(lambda: torch.matmul(torch.ones(n, t - r, t, device=dev), xm.float()))
    log(f"ToMe merge event batch {n} T {t} -> {t - r} bf16: {ms:.6g} ms (the fp32 merge GEMM "
        f"alone {gemm:.6g} ms); {card}")
    del xm, km
    torch.cuda.empty_cache()
    for ops in ("fused", "quant"):  # where the r = 13 forward's device time goes
        _profile_forward(VIT_B_16, params, x, ops, dev, card, TOME_R)
        gc.collect()
        torch.cuda.empty_cache()
    _train_rates(dev, card, {
        "fused_train r=0": ("fused_train", False), f"fused_train r={TOME_R}": (
            "fused_train", False, TOME_R),
        "fused_train regularized r=0": ("fused_train", True),
        f"fused_train regularized r={TOME_R}": ("fused_train", True, TOME_R),
    }, "ToMe train throughput")


def phase_tome_train_cli(workdir: str, extra, kernels) -> dict:
    """Phase 28: the train CLI with ``--tome TOME_R`` and ``extra`` flags,
    12 launches per step of each of ``kernels`` and none of any other, and a
    loss that falls over the steps (AdamW at TOME_LR: the CLI's default 1e-3
    is too hot at B/16 width, where a step of it can throw the loss up).
    -> launch counts of the run."""
    launches, losses = _train_cli(workdir, ["--tome", str(TOME_R), "--lr", str(TOME_LR), *extra])
    want = {name: 0 for name in launches}
    want.update({name: 12 * TRAIN_STEPS for name in kernels})
    if launches != want:
        raise RuntimeError(f"expected {want} kernel launches over {TRAIN_STEPS} steps, "
                           f"got {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"ToMe train CLI {extra}: the loss did not fall ({losses})")
    return launches


# -- the per-op tier (K21, K22) and the fused AdamW (K20) ---------------------


def per_op_kernel_cases(dev: torch.device):
    """-> ({kernel: [case]}, labels) for phase 31: K21 on strided views of a
    packed QKV (as the per-op attention calls it) and K22 at B/16 shapes for
    batch 100 and 3, bf16 and fp32, K21 also at phase 26's head width 80
    (batch 8), at @384 (T 577, batch 32) and at the switch to K13 (T 1,024,
    batch 8).  K21's library call is ``F.scaled_dot_product_attention`` on
    the same views."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import attention as k21
    from vit_tpu_torch.ops.kernels import mlp as k22

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 31)
    long_t = {"t577": (32, (384 // 16) ** 2 + 1), "t1024": (8, 1024)}
    labels = {**PER_OP_KERNELS, "scaled_dot_product_attention dh80": ("K21 dh80",),
              **{f"scaled_dot_product_attention {n}": (f"K21 {n}",) for n in long_t}}
    cases = {name: [] for name in labels}

    def sdpa_case(tag, dtype, b, t, d, h):
        q, k, v = packed_views(rn(b * t, 3 * d, dtype=dtype), b, t, h, 3)
        return case(tag, dtype, b, k21.scaled_dot_product_attention,
                    k21.scaled_dot_product_attention_plain, (q, k, v), 4 * b * t * t * d,
                    library=lambda: F.scaled_dot_product_attention(q, k, v))

    for dtype in (torch.bfloat16, torch.float32):
        w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
        w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        for b in BATCHES:
            rows = b * t
            tag = _tag(dtype, b, rows)
            cases["scaled_dot_product_attention"].append(sdpa_case(tag, dtype, b, t, d, h))
            cases["mlp"].append(case(tag, dtype, b, k22.mlp, k22.mlp_plain,
                                     (rn(rows, d, scale=2.0, dtype=dtype), w1, bb1, w2, bb2),
                                     4 * rows * d * f))
        b, t80, d80, h80 = H14["batch"], H14["t"], H14["d"], H14["heads"]
        cases["scaled_dot_product_attention dh80"].append(sdpa_case(
            _tag(dtype, b, b * t80) + f" T {t80} dh {d80 // h80}", dtype, b, t80, d80, h80))
        for n, (b, tl) in long_t.items():
            cases[f"scaled_dot_product_attention {n}"].append(sdpa_case(
                _tag(dtype, b, b * tl) + f" T {tl}", dtype, b, tl, d, h))
    return cases, labels


def phase_per_op_correctness(params, images: np.ndarray, dev: torch.device) -> dict:
    """Phase 33 (correctness): fp32 ``per_op`` vs fp32 ``eager`` (8 images,
    <= 1e-3), bf16 ``per_op`` vs fp32 ``fused`` by the comparator rule, and
    ``per_op`` at @512 batch 16 bf16, where the per-op attention routes to
    K13.  -> launch counts of that forward."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    logits = {}
    for dtype, ops, n in (("float32", "per_op", 8), ("float32", "eager", 8),
                          ("float32", "fused", 100), ("bfloat16", "per_op", 100)):
        eng = InferenceEngine(cfg, params, dtype, ops, dev, batch_pad=1)
        logits[dtype, ops] = eng.logits(images[:n]).cpu().numpy()
        del eng
        if not np.isfinite(logits[dtype, ops]).all():
            raise RuntimeError(f"{dtype} {ops} logits non-finite")
    d = float(np.abs(logits["float32", "per_op"] - logits["float32", "eager"]).max())
    log(f"fp32 per_op vs fp32 eager (card, TF32 off), 8 images: max|d logit|={d:.6g} (tol 1e-3)")
    if not d <= 1e-3:
        raise RuntimeError("fp32 per_op logits outside 1e-3 of the eager path")
    _comparator_rule("bf16 per_op vs fp32 fused", _probs(logits["bfloat16", "per_op"]),
                     _probs(logits["float32", "fused"]))
    torch.cuda.empty_cache()

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    eng = InferenceEngine(cfg, synth_params(cfg, 0), "bfloat16", "per_op", dev, batch_pad=16)
    x = synth_images(16, cfg, seed=5)
    wrappers = _reset_counts()
    l16 = eng.logits(x).cpu().numpy()
    launches = _expect_counts(
        wrappers, {"layer_norm": 25, "flash_attention_fwd": 12, "mlp": 12},
        f"long per_op {cfg.name} (T {cfg.seq_len}) batch 16 bf16, one forward")
    if l16.shape != (16, cfg.num_classes) or not np.isfinite(l16).all():
        raise RuntimeError(f"long per_op logits: shape {l16.shape} or non-finite")
    return launches


def _adamw_case(dev, p_dtype):
    """B/16's 20 leaves (fp32), or its largest leaf alone (bf16 p and g),
    with fp32 moments and ADAMW_STEPS gradients, made on the card."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime import trainer

    params = [t.to(dev, p_dtype) for t in trainer.leaves(
        vit.init_params(torch.Generator().manual_seed(0), VIT_B_16))]
    if p_dtype != torch.float32:
        params = [max(params, key=torch.numel)]
    rn = _rand(dev, 34)
    grads = [[rn(*p.shape, scale=1e-2, dtype=p_dtype) for p in params]
             for _ in range(ADAMW_STEPS)]
    return params, grads


def phase_adamw_kernel(dev: torch.device, card: str) -> dict:
    """Phase 34: K20 against its twin over ADAMW_STEPS steps, on every leaf
    of B/16's fp32 params and on its largest leaf in bf16: p, mu and nu
    within 2^-20 of each leaf's largest |value| (only FMA contraction
    differs: the build has no fast-math), a bf16 p within one rounding
    (2^-7); then one step over the 20 leaves: one launch, and its time —
    kernel and ``torch.optim.AdamW(fused=True).step()`` (the library call)
    in turns, each also as device time in a profiler trace, then the twin
    and torch's foreach step, all on the same tensors.  -> {adamw_update:
    summary}."""
    from vit_tpu_torch.ops.kernels import adamw as k20

    lr, wd = 1e-3, 0.05
    err = 0.0
    for p_dtype in (torch.float32, torch.bfloat16):
        params, grads = _adamw_case(dev, p_dtype)
        state = [[t.clone() for t in params]] + [
            [torch.zeros(t.shape, device=dev) for t in params] for _ in range(2)]
        twin = [[t.clone() for t in ts] for ts in state]
        for step, g in enumerate(grads, 1):
            k20.adamw_update(g, *state, step, lr, weight_decay=wd)
            k20.adamw_update_plain(g, *twin, step, lr, weight_decay=wd)
        torch.cuda.synchronize()
        worst = 0.0
        for what, got, want in zip(("p", "mu", "nu"), state, twin):
            for i, (a, b) in enumerate(zip(got, want)):
                rel = 2.0 ** -20 if a.dtype == torch.float32 else 2.0 ** -7
                e = (a.float() - b.float()).abs().max().item()
                tol = rel * b.float().abs().max().item()
                if not (e <= tol and torch.isfinite(a).all()):
                    raise RuntimeError(f"K20 {p_dtype} leaf {i} {what}: max|d|={e:.6g} > {tol:.6g}")
                err, worst = max(err, e), max(worst, e / tol if tol else 0.0)
        n = sum(t.numel() for t in params)
        log(f"K20 adamw_update p {str(p_dtype).removeprefix('torch.')}, {len(params)} leaves, "
            f"{n} elements, {ADAMW_STEPS} steps: p, mu, nu against the twin at most {worst:.3g} "
            f"of their tolerance")
        del state, twin

    params, grads = _adamw_case(dev, torch.float32)
    g = grads[0]
    n = sum(t.numel() for t in params)
    if (len(params), n) != B16_LEAVES:
        raise RuntimeError(f"B/16 has {len(params)} leaves of {n} parameters, expected {B16_LEAVES}")
    mu, nu = ([torch.zeros(t.shape, device=dev) for t in params] for _ in range(2))
    runs = {"kernel": lambda: k20.adamw_update(g, params, mu, nu, 1, lr, weight_decay=wd)}
    k20.adamw_update.launches = 0
    runs["kernel"]()
    per_step = k20.adamw_update.launches
    if per_step != 1:
        raise RuntimeError(f"K20: {per_step} launches for one step over B/16's leaves, expected 1")
    for kind in ("fused", "foreach"):
        leaves = [t.clone().requires_grad_(True) for t in params]
        for t, gt in zip(leaves, g):
            t.grad = gt
        runs[kind] = torch.optim.AdamW(leaves, lr=lr, weight_decay=wd, **{kind: True}).step
    turns = {"kernel": [], "fused": []}
    for _ in range(ADAMW_TURNS):  # in turns: kernel, fused, fused, kernel
        for kind in ("kernel", "fused", "fused", "kernel"):
            turns[kind].append(cuda_ms(runs[kind]))
    ms, fused_ms = (statistics.median(turns[k]) for k in ("kernel", "fused"))
    foreach_ms = cuda_ms(runs["foreach"])
    plain_ms = cuda_ms(lambda: k20.adamw_update_plain(g, params, mu, nu, 1, lr, weight_decay=wd))
    device = {kind: _device_ms(runs[kind]) for kind in ("kernel", "fused")}
    nbytes = _nbytes([*g, *params, *mu, *nu]) + _nbytes([*params, *mu, *nu])
    bound_ms, bound_by = bound(15 * n, nbytes, torch.float32)
    log(f"K20 adamw_update step, B/16 fp32, 20 leaves ({n} elements): kernel {ms:.6g} ms "
        f"({per_step} launch; turns {', '.join(f'{t:.6g}' for t in turns['kernel'])}; device "
        f"{device['kernel']:.6g} ms), plain {plain_ms:.6g} ms, torch.optim.AdamW fused "
        f"{fused_ms:.6g} ms (turns {', '.join(f'{t:.6g}' for t in turns['fused'])}; device "
        f"{device['fused']:.6g} ms), foreach {foreach_ms:.6g} ms, bound {bound_ms:.6g} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it); {card}")
    return {"adamw_update": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": fused_ms}}


def _device_ms(fn, steps: int = 10) -> float:
    """Device time of ``fn`` in ms: the sum of its kernels' durations over
    ``steps`` calls in a torch.profiler trace, per call.  Annotations that
    the trace also places on the device timeline (``Optimizer.step``'s
    record_function) span kernels and are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps


def phase_adamw_train_cli(workdir: str) -> dict:
    """Phase 35: the train CLI with ``--optimizer fused_adamw`` at TRAIN_LR
    (otherwise as phase 8): one K20 launch per step (one table of the 20
    leaves) beside phase 8's 12 each of K1, K4-K7, and a loss that falls.
    -> launch counts of the run."""
    launches, losses = _train_cli(workdir, ["--optimizer", "fused_adamw", "--lr", str(TRAIN_LR)])
    want = {name: 0 for name in launches}
    want.update({name: 12 * TRAIN_STEPS for name in ("ln_qkv_attn", *TRAIN_KERNELS)})
    want["adamw_update"] = TRAIN_STEPS
    if launches != want:
        raise RuntimeError(f"expected {want} kernel launches over {TRAIN_STEPS} steps, "
                           f"got {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"fused AdamW train CLI: the loss did not fall ({losses})")
    return launches


# -- tensor/data parallelism (K5 partial, K18) and the kernel study (K19) ------


def tp_kernel_cases(dev: torch.device):
    """-> (K5-partial and local-head K1 cases for ``phase_kernels``, K18a,
    K18b and local-head K15 cases for ``phase_quant_kernels``, labels) for
    phase 36: rank 0's shard at tp = 2 and 4 (F/tp hidden columns, heads/tp
    heads) of B/16 at batch 100 and 3, bf16 and fp32.  K18b's row scales
    come from the whole hidden row, as the tensor-parallel MLP hands them."""
    from vit_tpu_torch.eval import quant_stages as qs
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 36)
    labels = {**TP_KERNELS, **{f"ln_mlp_residual partial tp{tp}": (f"K5 partial tp{tp}",)
                               for tp in TP_SIZES},
              **{f"ln_qkv_attn {h // tp} heads": (f"K1 tp{tp}",) for tp in TP_SIZES},
              **{f"ln_qkv_attn_q8 {h // tp} heads": (f"K15 tp{tp}",) for tp in TP_SIZES}}
    fp_cases = {name: [] for name in labels if name.startswith("ln_mlp") or
                name.startswith("ln_qkv_attn ")}
    q8_cases = {name: [] for name in labels if name not in fp_cases}

    def k5_partial(x, s, b, w1, b1, w2, eps, variant):
        return k5.ln_mlp_residual(x, s, b, w1, b1, w2, None, eps, variant, partial=True)

    for dtype in (torch.bfloat16, torch.float32):
        s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
        w2 = rn(f, d, scale=f ** -0.5, dtype=dtype)
        (w1q, w1s), (w2q, _) = (quant.quantize_weight(rn(d, f, scale=d ** -0.5)),
                                quant.quantize_weight(rn(f, d, scale=f ** -0.5)))
        wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
        wq, ws = quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5))
        fast = dtype == torch.bfloat16  # the tensor-parallel MLP's erf form
        for b in BATCHES:
            rows = b * t
            x = rn(rows, d, scale=2.0, dtype=dtype)
            whole = k18a.ln_fc1_gelu_q8_plain(x, s2, b2n, w1q, w1s, bb1, 1e-6, "exact", fast)
            mmax = whole.abs().amax(-1, keepdim=True)
            ms = torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)
            for tp in TP_SIZES:
                fl, c3 = f // tp, slice(0, 3 * d // tp)
                c = slice(0, fl)
                tag = f"{_tag(dtype, b, rows)} tp {tp} (rank 0: F/tp {fl}, {h // tp} heads)"
                on_path = dtype == torch.bfloat16 and b == BATCHES[0] and tp == 2
                a5 = (x, s2, b2n, w1[:, c].contiguous(), bb1[c].contiguous(), w2[c].contiguous(),
                      1e-6, "exact")
                fp_cases[f"ln_mlp_residual partial tp{tp}"].append(dict(
                    case(tag, dtype, b, k5_partial, k5.ln_mlp_partial_plain, a5,
                         4 * rows * d * fl), summary=False))
                a1 = (x, s2, b2n, wqkv[:, c3].contiguous(), bqkv[c3].contiguous(), h // tp, t,
                      1e-6)
                fp_cases[f"ln_qkv_attn {h // tp} heads"].append(dict(
                    case(tag, dtype, b, k1.ln_qkv_attn, k1.ln_qkv_attn_plain, a1,
                         2 * rows * d * 3 * d // tp + 4 * b * t * t * d // tp), summary=False))
                a18a = (x, s2, b2n, w1q[:, c].contiguous(), w1s[c].contiguous(),
                        bb1[c].contiguous(), 1e-6, "exact", fast)
                q8_cases["ln_fc1_gelu_q8"].append(dict(
                    tag=tag, dtype=dtype, batch=b, args=a18a, out="mid", summary=on_path,
                    kernel=k18a.ln_fc1_gelu_q8, stages=k18a._ln_fc1_gelu_q8_stages,
                    plain=k18a.ln_fc1_gelu_q8_plain, check=qs.check_ln_fc1_gelu_q8,
                    int8_ops=2 * rows * d * fl, flops=0))
                a18b = (whole[:, c].contiguous(), ms, w2q[c].contiguous())
                q8_cases["fc2_q8_partial"].append(dict(
                    tag=tag, dtype=dtype, batch=b, args=a18b, out="out", summary=on_path,
                    kernel=k18b.fc2_q8_partial, stages=k18b._fc2_q8_partial_stages,
                    plain=k18b.fc2_q8_partial_plain, check=qs.check_fc2_q8_partial,
                    int8_ops=2 * rows * fl * d, flops=0))
                a15 = (x, s2, b2n, wq[:, c3].contiguous(), ws[c3].contiguous(),
                       bqkv[c3].contiguous(), h // tp, t, 1e-6)
                q8_cases[f"ln_qkv_attn_q8 {h // tp} heads"].append(dict(
                    tag=tag, dtype=dtype, batch=b, args=a15, out="ctx", summary=False,
                    kernel=k15.ln_qkv_attn_q8, stages=k15._ln_qkv_attn_q8_stages,
                    plain=k15.ln_qkv_attn_q8_plain, check=qs.check_ln_qkv_attn_q8,
                    int8_ops=2 * rows * d * 3 * d // tp, flops=4 * b * t * t * d // tp))
    return fp_cases, q8_cases, labels


def phase_k18_composed(dev: torch.device) -> None:
    """Phase 36 (composition): K18a on each of tp shards, the row maxima's
    maximum, K18b on each shard and the int32 sum over shards, in one
    process, against K17 on the same x (B/16 batch 100): mid, the row
    scales and the int32 FC2 sums bit for bit those of K17's stages (its
    hq/hs are K18a's own stage 1, checked in the cases), the output within
    one rounding of the dtype."""
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as k17
    from vit_tpu_torch.ops.kernels.fc2_q8_partial import _fc2_q8_partial_stages
    from vit_tpu_torch.ops.kernels.ln_fc1_gelu_q8 import _ln_fc1_gelu_q8_stages

    d, f, rows = B16["d"], B16["f"], BATCHES[0] * B16["t"]
    rn = _rand(dev, 37)
    for dtype in (torch.bfloat16, torch.float32):
        x = rn(rows, d, scale=2.0, dtype=dtype)
        s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        (w1q, w1s), (w2q, w2s) = (quant.quantize_weight(rn(d, f, scale=d ** -0.5)),
                                  quant.quantize_weight(rn(f, d, scale=f ** -0.5)))
        bb1, bb2 = rn(f, scale=0.1, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        st = k17._ln_mlp_residual_q8_stages(x, s2, b2n, w1q, w1s, bb1, w2q, w2s, bb2, 1e-6)
        for tp in TP_SIZES:
            cols = [slice(r * f // tp, (r + 1) * f // tp) for r in range(tp)]
            a = [_ln_fc1_gelu_q8_stages(x, s2, b2n, w1q[:, c].contiguous(), w1s[c].contiguous(),
                                        bb1[c].contiguous(), 1e-6, "exact",
                                        dtype == torch.bfloat16) for c in cols]
            mmax = torch.stack([s["mid"].abs().amax(-1, keepdim=True) for s in a]).amax(0)
            ms = torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)
            bs = [_fc2_q8_partial_stages(s["mid"], ms, w2q[c].contiguous())
                  for s, c in zip(a, cols)]
            acc = sum(s["out"] for s in bs)
            out = ((acc.float() * ms * w2s + bb2.float()) + x.float()).to(dtype)
            same = {
                "hq": all(torch.equal(s["hq"], st["hq"]) for s in a),
                "hs": all(torch.equal(s["hs"], st["hs"]) for s in a),
                "mid": torch.equal(torch.cat([s["mid"] for s in a], 1), st["mid"]),
                "ms": torch.equal(ms[:, 0], st["ms"]),
                "mq": torch.equal(torch.cat([s["mq"] for s in bs], 1), st["mq"]),
                "int32 sums": torch.equal(acc, quant.int8_dot(st["mq"], w2q).to(torch.int32)),
            }
            ulp = 2.0 ** (-23 if dtype == torch.float32 else -7)  # one rounding of the dtype
            err = ((out.float() - st["out"].float()).abs()
                   / st["out"].float().abs().clamp(min=1.0)).max().item()
            log(f"K18 composed over tp {tp} vs K17, {_tag(dtype, BATCHES[0], rows)}: "
                + ", ".join(f"{k} {'bit for bit' if v else 'DIFFERS'}" for k, v in same.items())
                + f"; output max rel|d| {err:.6g} (one rounding: {ulp:.3g})")
            if not all(same.values()) or not err <= ulp:
                raise RuntimeError(f"K18 over tp {tp} ({dtype}) is not K17's arithmetic")
        del st


def study_kernel_cases(dev: torch.device):
    """-> ({kernel: [case]}, labels) for phase 37: K19 with int8 p·v and
    with p·v in the dtype, and K15 beside them, at B/16 batch 100 and 3,
    bf16, held by the stage checks."""
    from vit_tpu_torch.eval import quant_stages as qs
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

    d, h, t = B16["d"], B16["heads"], B16["t"]
    rn = _rand(dev, 38)
    labels = {**STUDY_KERNELS, "ln_qkv_attn_q8a quant_pv=False": ("K19 int8 q·kᵀ only",),
              "ln_qkv_attn_q8": QUANT_KERNELS["ln_qkv_attn_q8"]}
    cases = {name: [] for name in labels}
    dtype = torch.bfloat16
    s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
    wq, ws = quant.quantize_weight(rn(d, 3 * d, scale=d ** -0.5))
    bqkv = rn(3 * d, scale=0.1, dtype=dtype)
    for b in BATCHES:
        rows = b * t
        args = (rn(rows, d, scale=2.0, dtype=dtype), s1, b1n, wq, ws, bqkv, h, t, 1e-6)
        qkv_ops, att = 2 * rows * d * 3 * d, 2 * b * t * t * d
        for name, qpv in (("ln_qkv_attn_q8a", True), ("ln_qkv_attn_q8a quant_pv=False", False)):
            cases[name].append(dict(
                tag=_tag(dtype, b, rows), dtype=dtype, batch=b, args=args, out="ctx",
                summary=qpv and b == BATCHES[0],
                kernel=lambda *a, q=qpv: k15.ln_qkv_attn_q8a(*a, quant_pv=q),
                stages=lambda *a, q=qpv: k15._ln_qkv_attn_q8a_stages(*a, quant_pv=q,
                                                                     return_p=q),
                plain=lambda *a, q=qpv: k15.ln_qkv_attn_q8a_plain(*a, quant_pv=q),
                check=lambda st, end, *a, q=qpv: qs.check_ln_qkv_attn_q8a(st, end, *a,
                                                                         quant_pv=q),
                int8_ops=qkv_ops + (2 if qpv else 1) * att, flops=0 if qpv else att))
        cases["ln_qkv_attn_q8"].append(dict(
            tag=_tag(dtype, b, rows), dtype=dtype, batch=b, args=args, out="ctx", summary=False,
            kernel=k15.ln_qkv_attn_q8, stages=k15._ln_qkv_attn_q8_stages,
            plain=k15.ln_qkv_attn_q8_plain, check=qs.check_ln_qkv_attn_q8, int8_ops=qkv_ops,
            flops=2 * att))
    return cases, labels


def phase_kernel_study(card: str) -> dict:
    """Phase 37 (the study): ``python3 -m vit_tpu_torch.cli.bench_kernels
    --batch 100`` over every kernel of its list, counts set to 0 just
    before and read just after.  -> launch counts of the run."""
    from vit_tpu_torch.cli import bench_kernels

    stacks = 12 * (bench_kernels.WARMUP + bench_kernels.ITERS)
    buf = io.StringIO()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = bench_kernels.main(["--batch", "100", "--which", ",".join(bench_kernels.WHICH)])
    for line in buf.getvalue().splitlines():
        log(f"bench_kernels --batch 100: {line}; {card}")
    if rc != 0:
        raise RuntimeError(f"bench_kernels exited {rc}")
    return _expect_counts(
        wrappers, {"ln_qkv_attn": 2 * stacks, "ln_qkv_attn_q8": stacks,
                   "ln_qkv_attn_q8a": 2 * stacks, "out_residual": stacks,
                   "ln_mlp_residual": stacks, "out_ln_mlp_residual_q8": stacks},
        "kernel study (bench_kernels, a b c a8 c8 a8qk a8a awide)")


# phase 38's CLI runs on two ranks: their flags and each rank's launches
RANK_RUNS = {
    "classify_quant_tp": (["--ops", "quant", "--tp", "2"],
                          {"ln_qkv_attn_q8": 12, "ln_fc1_gelu_q8": 12, "fc2_q8_partial": 12,
                           "layer_norm": 1}),
    "classify_tp": (["--ops", "fused", "--tp", "2"],
                    {"ln_qkv_attn": 12, "ln_mlp_residual": 12, "layer_norm": 1}),
    "classify_dp": (["--ops", "fused", "--dp", "2"],
                    {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}),
}
LONG_TP_LAUNCHES = {"flash_attention_fwd": 12, "ln_mlp_residual": 12, "layer_norm": 1}
RANK_ENGINES = {  # name: (ops, dtype, mesh)
    "fused tp2 fp32": ("fused", "float32", {"dp": 1, "tp": 2}),
    "fused dp2 fp32": ("fused", "float32", {"dp": 2, "tp": 1}),
    "quant tp2 bf16": ("quant", "bfloat16", {"dp": 1, "tp": 2}),
    "fused tp2 bf16": ("fused", "bfloat16", {"dp": 1, "tp": 2}),
    "fused dp2 bf16": ("fused", "bfloat16", {"dp": 2, "tp": 1}),
}


class _RowSpy:
    """A kernel wrapper that records the rows of each call; its launch
    count is the wrapper's own (the wrapper adds to it by its module name)."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, x2d, *args, **kwargs):
        self.rows.append(x2d.shape[0])
        return self.fn(x2d, *args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def rank_worker(workdir: str) -> None:
    """One rank of phase 38 (``torchrun`` starts ``RANKS`` of them from
    ``phase_parallel``): the three CLI runs of ``RANK_RUNS``, each with
    every count set to 0 just before and read just after (and, on the dp
    run, the rows each K1 launch takes); the engines of ``RANK_ENGINES`` on
    the CLI's 100 images (logits, and the bf16 ones' time per forward);
    the tensor-parallel forward @512 batch 16 with its counts.  Writes
    ``rank<r>.json`` (and, on rank 0, the logits) into ``workdir``."""
    import torch.distributed as dist

    from vit_tpu_torch.cli.main import main as classify
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = f"{workdir}/params.npz"
    report = {"rc": {}, "launches": {}, "stdout": {}, "ms": {}}
    real_k1, k1_spy = k1.ln_qkv_attn, _RowSpy(k1.ln_qkv_attn)
    for path, (flags, _) in RANK_RUNS.items():
        buf = io.StringIO()
        wrappers = _reset_counts()
        k1.ln_qkv_attn = k1_spy if path == "classify_dp" else real_k1
        with contextlib.redirect_stdout(buf):
            rc = classify(["--weights", weights, "--synth", "100", "--dtype", "bfloat16",
                           "--device", "cuda", "--batch-pad", "100", "--json", "--dist-backend",
                           "gloo", "--output", f"{workdir}/{path}.txt", *flags])
        k1.ln_qkv_attn = real_k1
        report["rc"][path] = rc
        report["launches"][path] = {name: fn.launches for name, fn in wrappers.items()}
        out = buf.getvalue().splitlines()
        report["stdout"][path] = out[:2] + out[-2:]
    report["k1_rows_dp"] = k1_spy.rows
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    params = load_params_any(weights, VIT_B_16)
    images = synth_images(100, VIT_B_16, seed=0)  # the CLI's --synth 100
    logits = {}
    for name, (ops, dtype, axes) in RANK_ENGINES.items():
        eng = InferenceEngine(VIT_B_16, params, dtype, ops, dev, batch_pad=100,
                              mesh=make_mesh(axes))
        logits[name] = eng.logits(images).float().cpu().numpy()
        if dtype == "bfloat16":
            x = torch.from_numpy(images).to(dev, torch.bfloat16)
            times = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.logits(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            report["ms"][name] = statistics.median(times) * 1e3
        del eng
        torch.cuda.empty_cache()
    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    eng = InferenceEngine(cfg, synth_params(cfg, 0), "bfloat16", "fused", dev, batch_pad=16,
                          mesh=make_mesh({"dp": 1, "tp": 2}))
    x = synth_images(16, cfg, seed=5)
    wrappers = _reset_counts()
    l16 = eng.logits(x).float().cpu().numpy()
    torch.cuda.synchronize()
    report["launches"]["classify_tp_long"] = {name: fn.launches for name, fn in wrappers.items()}
    report["long_finite"] = bool(np.isfinite(l16).all()) and l16.shape == (16, cfg.num_classes)
    with open(f"{workdir}/rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    if rank == 0:
        np.savez(f"{workdir}/logits.npz", **{k.replace(" ", "_"): v for k, v in logits.items()})


def _line_rule(what: str, path: str, ref_path: str, p32: np.ndarray) -> None:
    """The comparator rule on two result files: no label differs where the
    fp32 probabilities ``p32`` are decisive (top-1 beats top-2 by more than
    0.01), and the top probabilities differ by at most 0.01."""
    from vit_tpu_torch.eval import comparator

    got, ref = comparator.parse_result_file(path), comparator.parse_result_file(ref_path)
    if [r.index for r in got] != list(range(len(p32))):
        raise RuntimeError(f"{what}: {path} is not {len(p32)} well-formed lines")
    top2 = np.sort(p32, -1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 0.01
    bad = sum(1 for g, r, dcs in zip(got, ref, decisive) if dcs and g.label != r.label)
    dev = max(abs(g.prob - r.prob) for g, r in zip(got, ref))
    log(f"{what}, {len(got)} lines: {int(decisive.sum())} decisive, {bad} decisive label "
        f"mismatches (tol 0), top-prob max|d|={dev:.6g} (tol 0.01)")
    if bad or not dev <= 0.01:
        raise RuntimeError(f"{what}: fails the comparator rule")


def phase_parallel(params, dev: torch.device, card: str, workdir: str) -> dict:
    """Phase 38: two ranks share the card over gloo, started by ``torchrun``
    with a time limit (a rank that hangs, or fails, fails the phase):
    ``rank_worker``'s CLI runs with their launch counts on every rank
    (``RANK_RUNS``; the dp run's K1 launches on 50 images each), their
    result lines against the single-card CLI's by the comparator rule, fp32
    ``fused`` tp and dp logits within 1e-4 of the single card's, the bf16
    time per forward (two ranks sharing one card: not a scaling figure), and
    the tensor-parallel forward @512 (12 K13 per rank).  -> launch counts of
    rank 0, by path."""
    import os
    import signal
    import sys

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    refs = {}
    for ops, kernels in (("quant", ("ln_qkv_attn_q8", "out_ln_mlp_residual_q8")),
                         ("fused", ("ln_qkv_attn", "out_ln_mlp_residual"))):
        phase_cli(params, workdir, ops, kernels)  # saves params.npz, writes result.txt
        refs[ops] = f"{workdir}/single_{ops}.txt"
        os.replace(f"{workdir}/result.txt", refs[ops])
    images = synth_images(100, VIT_B_16, seed=0)  # the CLI's --synth 100
    f32 = InferenceEngine(VIT_B_16, params, "float32", "fused", dev, batch_pad=100)
    l32 = f32.logits(images).cpu().numpy()
    del f32
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(RANKS), os.path.abspath(__file__), "--rank-worker", workdir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="4"))
    try:
        out, _ = proc.communicate(timeout=RANKS_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and every rank it started
        proc.communicate()
        raise RuntimeError(f"{RANKS} ranks did not finish in {RANKS_TIMEOUT} s: a rank hung")
    lines = [ln for ln in out.splitlines() if "socket.cpp" not in ln]
    log("\n".join(f"ranks: {ln}" for ln in (lines if proc.returncode else lines[-12:])))
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun with {RANKS} ranks exited {proc.returncode}")
    log(f"{RANKS} ranks over gloo on one card: {time.perf_counter() - t0:.3f} s")
    reports = [json.load(open(f"{workdir}/rank{r}.json")) for r in range(RANKS)]
    for r, rep in enumerate(reports):
        for path, (_, want) in RANK_RUNS.items():
            if rep["rc"][path] != 0:
                raise RuntimeError(f"rank {r} {path}: the CLI exited {rep['rc'][path]}")
            _expect_counts_of(rep["launches"][path], want, f"rank {r} {path} (cli bf16 b100)")
        _expect_counts_of(rep["launches"]["classify_tp_long"], LONG_TP_LAUNCHES,
                          f"rank {r} classify_tp_long (@512 batch 16 bf16 fused tp 2)")
        if rep["k1_rows_dp"] != [50 * B16["t"]] * 12:
            raise RuntimeError(f"rank {r} classify_dp: K1 took {rep['k1_rows_dp']} rows")
        if not rep["long_finite"]:
            raise RuntimeError(f"rank {r}: @512 tp logits non-finite or misshapen")
    log("\n".join(f"ranks: {path}: " + " / ".join(reports[0]["stdout"][path])
                  for path in RANK_RUNS))
    p32 = _probs(l32)
    _line_rule("bf16 quant tp 2 vs single-card quant (CLI lines)",
               f"{workdir}/classify_quant_tp.txt", refs["quant"], p32)
    for path in ("classify_tp", "classify_dp"):
        _line_rule(f"bf16 fused {path} vs single-card fused (CLI lines)",
                   f"{workdir}/{path}.txt", refs["fused"], p32)
    logits = dict(np.load(f"{workdir}/logits.npz"))
    for name in ("fused_tp2_fp32", "fused_dp2_fp32"):
        d = float(np.abs(logits[name] - l32).max())
        log(f"{name} vs single-card fp32 fused, 100 images: max|d logit|={d:.6g} (tol 1e-4)")
        if not d <= 1e-4:
            raise RuntimeError(f"{name} logits outside 1e-4 of the single card's")
    for name, ms in reports[0]["ms"].items():
        log(f"{name} B/16 batch 100: {ms:.6g} ms per forward, {RANKS} ranks sharing one card "
            f"over gloo (not a scaling figure); {card}")
    return {path: reports[0]["launches"][path] for path in (*RANK_RUNS, "classify_tp_long")}


def group_parallel(dev, card, summary, launches) -> None:
    """Phases 36-38."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.ops.kernels import _build

    fp_cases, q8_cases, labels = tp_kernel_cases(dev)
    phase_kernels(fp_cases, labels, BATCHES[0])
    summary.update(phase_quant_kernels(q8_cases, labels))
    del fp_cases, q8_cases
    torch.cuda.empty_cache()
    phase_k18_composed(dev)
    torch.cuda.empty_cache()
    phase_k18_split(dev, card)
    torch.cuda.empty_cache()
    cases, labels = study_kernel_cases(dev)
    summary.update({k: v for k, v in phase_quant_kernels(cases, labels).items()
                    if k in STUDY_KERNELS})
    del cases
    torch.cuda.empty_cache()
    phase_k19_split(dev, card)
    torch.cuda.empty_cache()
    launches["kernel_study"] = phase_kernel_study(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches.update(phase_parallel(synth_params(VIT_B_16, 0), dev, card, workdir))


# the serving group (phases 39-41): InferenceServer and vit-tpu-torch-serve
SERVE_MAX_BATCH = 64  # the serve CLI's defaults
SERVE_PAD = 32
SERVE_DELAY_MS = 5.0
SERVE_POOL = 256  # the requests are slices of one pool of synthetic images
SERVE_THREADS = 4  # phase 39's submitting threads
SERVE_WAIT = 300  # s: the bound on every wait of phases 39-41
# phase 39's runs: name -> (ops, dtype, ToMe r, requests, K per batch, check)
SERVE_RUNS = {
    "serve": ("fused", "bfloat16", 0, 200,
              {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}, "rule"),
    "serve_fp32": ("fused", "float32", 0, 48,
                   {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}, "fp32"),
    "serve_quant": ("quant", "bfloat16", 0, 32,
                    {"ln_qkv_attn_q8": 12, "out_ln_mlp_residual_q8": 12, "layer_norm": 1}, "rule"),
    "serve_tome": ("fused", "bfloat16", TOME_R, 32,
                   {"ln_qkv_attn": 12, "out_residual": 12, "ln_mlp_residual": 12}, "rule"),
}
SELFTEST_REQUESTS = 400
# the /metrics names, the JAX daemon's
METRIC_NAMES = sorted(f"vit_tpu_{name}" for name in (
    "requests_total", "images_total", "batches_total", "images_per_batch",
    "deadline_expired_total", "request_latency_seconds_bucket", "request_latency_seconds_sum",
    "request_latency_seconds_count", "request_latency_p50_seconds",
    "request_latency_p99_seconds"))
SELFTEST_SHARES = (0.5, 0.7, 0.9)  # of the saturated request rate, paced
SERVE_BUSY_BATCHES = 20


def _serve_stream():
    """Phase 39's traffic: 200 requests of 1-64 images from default_rng(0),
    each a slice (offset, size) of the pool."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, SERVE_MAX_BATCH + 1, 200)
    return [(int(rng.integers(0, SERVE_POOL - n + 1)), int(n)) for n in sizes]


def _serve_run(name: str, params, pool: np.ndarray, p32_pool: np.ndarray, dev, card: str) -> dict:
    """One run of phase 39: an ``InferenceServer`` (max_batch 64, batch_pad 32,
    5 ms) warmed up, each request's answer from the same engine alone, the
    counts set to 0, the stream submitted by 4 threads (every third request
    with ``return_probs``), the counts read; then the answers against the
    engine's.  -> launch counts of the served stream."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import results
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.serving import InferenceServer

    ops, dtype, tome_r, count, per_batch, check = SERVE_RUNS[name]
    stream = _serve_stream()[:count]
    requests = [pool[o:o + n] for o, n in stream]
    engine = InferenceEngine(VIT_B_16, params, dtype, ops, dev, batch_pad=SERVE_PAD,
                             tome_r=tome_r)
    server = InferenceServer(engine, max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS,
                             max_queue_images=1 << 31)
    t0 = time.perf_counter()
    server.warmup()
    warm = time.perf_counter() - t0
    want = [engine.classify(r) for r in requests]
    futures = [None] * len(requests)

    def client(k):
        for i in range(k, len(requests), SERVE_THREADS):
            futures[i] = server.submit(requests[i], return_probs=(i % 3 == 0))

    wrappers = _reset_counts()
    with server:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_WAIT)
        if any(t.is_alive() for t in threads) or None in futures:
            raise RuntimeError(f"{name}: a client thread did not submit its requests")
        got = [f.result(timeout=SERVE_WAIT) for f in futures]
        wall = time.perf_counter() - t0
    stats = server.stats
    what = (f"{name} ({ops} {dtype}{f' ToMe r={tome_r}' if tome_r else ''}, {len(requests)} "
            f"requests, {sum(n for _, n in stream)} images, {stats.batches} batches)")
    launches = _expect_counts(wrappers, {k: n * stats.batches for k, n in per_batch.items()},
                              what)
    log(f"{what}: warmup {warm:.6g} s, served in {wall:.6g} s, {stats.images_per_batch:.6g} "
        f"images/batch; {card}")
    if not stats.batches < len(requests):
        raise RuntimeError(f"{what}: no two requests shared a batch")
    for i, (_, _, probs) in enumerate(got):
        if (probs is None) != (i % 3 != 0):
            raise RuntimeError(f"{what}: request {i}'s probabilities "
                               f"{'missing' if probs is None else 'unasked'}")
        if probs is not None:
            sums = np.abs(probs.sum(-1) - 1.0).max()
            if not (probs.shape == (stream[i][1], VIT_B_16.num_classes) and sums <= 1e-5):
                raise RuntimeError(f"{what}: request {i}'s probabilities {probs.shape}, "
                                   f"rows sum to 1 within {sums}")
    labels = np.concatenate([g[0] for g in got])
    top = np.concatenate([g[1] for g in got])
    want_labels = np.concatenate([w[0] for w in want])
    want_top = np.concatenate([w[1] for w in want])
    if check == "fp32":
        d = float(np.abs(top - want_top).max())
        bad = int((labels != want_labels).sum())
        log(f"{what} vs the engine alone: {bad} label mismatches (tol 0), top-prob max|d|={d:.6g} "
            f"(tol 1e-5)")
        if bad or not d <= 1e-5:
            raise RuntimeError(f"{what}: answers differ from the engine's")
    else:
        with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
            results.write_result_file(labels, top, f"{tmp}/served.txt")
            results.write_result_file(want_labels, want_top, f"{tmp}/alone.txt")
            p32 = np.concatenate([p32_pool[o:o + n] for o, n in stream])
            _line_rule(f"{what} vs the engine alone", f"{tmp}/served.txt", f"{tmp}/alone.txt",
                       p32)
    return launches


def _build_dir():
    from vit_tpu_torch.ops.kernels import _build

    return _build.BUILD_DIR


def phase_server(params, dev, card: str) -> dict:
    """Phase 39: the server on the card against the engine (``SERVE_RUNS``).
    -> launch counts by path."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    pool = synth_images(SERVE_POOL, VIT_B_16, seed=2)
    f32 = InferenceEngine(VIT_B_16, params, "float32", "fused", dev, batch_pad=SERVE_PAD)
    p32_pool = f32.probabilities(pool).cpu().numpy()
    del f32
    launches = {}
    for name in SERVE_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        launches[name] = _serve_run(name, params, pool, p32_pool, dev, card)
    return launches


def phase_serve_selftest(params, dev, card: str, workdir: str) -> None:
    """Phase 40: ``vit-tpu-torch-serve --selftest 400`` in-process (bf16
    ``fused``, the CLI's defaults), saturated and ``--staged``, then paced
    at 50/70/90% of the saturated request rate; one line each.  Then the
    static forward at batch 64 on the same tensors, and the saturated
    server's device busy share over 20 batches (profiler kernel time over
    wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.cli import serve
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.serving import InferenceServer, ServerStats

    weights = f"{workdir}/params.npz"
    checkpoint.save_npz(params, weights)

    def selftest(extra, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["--weights", weights, "--device", "cuda", "--dtype", "bfloat16",
                             "--ops", "fused", "--selftest", str(SELFTEST_REQUESTS), *extra])
        if rc != 0:
            raise RuntimeError(f"vit-tpu-torch-serve {' '.join(extra)} exited {rc}")
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"serve selftest {what}: {out['value']} img/s, {out['images']} images in "
            f"{out['requests']} requests, {out['images_per_batch']} images/batch "
            f"({out['batches']} batches), p50 {out['latency_p50_ms']} ms, p99 "
            f"{out['latency_p99_ms']} ms, offered {out.get('offered_rps', 'all at t=0')} "
            f"requests/s; {card}")
        return out

    sat = selftest([], "saturated")
    staged = selftest(["--staged"], "saturated --staged")
    rps = sat["requests"] * sat["value"] / sat["images"]
    for share in SELFTEST_SHARES:
        selftest(["--selftest-rate", f"{share * rps:.6g}"],
                 f"paced at {share:.0%} of saturated ({share * rps:.6g} requests/s)")

    engine = InferenceEngine(VIT_B_16, params, "bfloat16", "fused", dev, batch_pad=SERVE_PAD)
    x = torch.from_numpy(synth_images(SERVE_MAX_BATCH, VIT_B_16, seed=3)).to(dev, torch.bfloat16)
    static = SERVE_MAX_BATCH / (cuda_ms(lambda: engine.logits(x)) / 1e3)
    log(f"static fused forward, batch {SERVE_MAX_BATCH} bf16: {static:.6g} img/s; the staged "
        f"server reaches {staged['value'] / static:.1%} of it; {card}")
    server = InferenceServer(engine, max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS,
                             max_queue_images=1 << 31)
    server.warmup()
    with server:
        server.classify(x, timeout=SERVE_WAIT)
        server.stats = ServerStats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futures = [server.submit(x) for _ in range(SERVE_BUSY_BATCHES)]
            for f in futures:
                f.result(timeout=SERVE_WAIT)
            wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    if server.stats.batches != SERVE_BUSY_BATCHES:
        raise RuntimeError(f"busy share: {server.stats.batches} batches, "
                           f"expected {SERVE_BUSY_BATCHES}")
    log(f"saturated server, {SERVE_BUSY_BATCHES} staged batches of {SERVE_MAX_BATCH} bf16 fused: "
        f"{wall:.6g} ms wall (profiler on), device {busy:.6g} ms ({busy / wall:.1%} busy, idle "
        f"{1 - busy / wall:.1%}), {SERVE_BUSY_BATCHES * SERVE_MAX_BATCH / wall * 1e3:.6g} img/s; "
        f"{card}")


def _http(port: int, method: str, path: str, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_WAIT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _same_answers(what: str, payload: dict, want: tuple) -> None:
    """The daemon's JSON results equal (labels, top) bit for bit: the same
    kernels at the same padded size."""
    labels = [r["label"] for r in payload["results"]]
    probs = np.array([r["prob"] for r in payload["results"]], np.float32)
    d = float(np.abs(probs - want[1]).max())
    log(f"{what}: labels {labels[:8]}, top-prob max|d| vs the engine {d:.6g} (tol 0)")
    if labels != [int(v) for v in want[0]] or d != 0:
        raise RuntimeError(f"{what}: the daemon's answers differ from the engine's")


def phase_serve_http(params, dev, card: str, workdir: str) -> dict:
    """Phase 41: the HTTP daemon on an ephemeral port (bf16 ``fused``,
    ``--allow-reload``): a bin body of 8 images and one PNG against the
    engine; ``X-Deadline-Ms: 0`` answered 504; ``/healthz``, ``/metrics``;
    ``/reload`` to seed-1 weights, after which the answers are a seed-1
    engine's; counts set to 0 once it listens and read at the end.  Then
    the rollout in fp32 on the card under TF32 settings against a float64
    CPU composition of the same probabilities.  -> launch counts."""
    import queue
    from PIL import Image

    from vit_tpu_torch.cli import serve
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.preprocess import preprocess_image
    from vit_tpu_torch.runtime.engine import InferenceEngine

    w0, w1 = f"{workdir}/params.npz", f"{workdir}/params_seed1.npz"
    params1 = synth_params(VIT_B_16, 1)
    checkpoint.save_npz(params, w0)
    checkpoint.save_npz(params1, w1)
    imgs = synth_images(8, VIT_B_16, seed=5)
    body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
    rgb = (np.random.default_rng(9).random((256, 320, 3)) * 255).astype(np.uint8)
    png = io.BytesIO()
    Image.fromarray(rgb).save(png, format="PNG")
    png_img = preprocess_image(Image.open(io.BytesIO(png.getvalue())), VIT_B_16.image_size)[None]
    e0 = InferenceEngine(VIT_B_16, params, "bfloat16", "fused", dev, batch_pad=SERVE_PAD)
    want0, want_png = e0.classify(imgs), e0.classify(png_img)
    del e0
    e1 = InferenceEngine(VIT_B_16, params1, "bfloat16", "fused", dev, batch_pad=SERVE_PAD)
    want1 = e1.classify(imgs)
    del e1

    args = serve.build_parser().parse_args(["--weights", w0, "--port", "0", "--allow-reload",
                                            "--device", "cuda", "--ops", "fused",
                                            "--dtype", "bfloat16"])
    cfg, ops, server = serve._build_server(args)
    listening = queue.Queue()
    t = threading.Thread(target=serve._http_daemon, args=(args, cfg, ops, server),
                         kwargs={"on_listen": listening.put}, daemon=True)
    t.start()
    httpd = listening.get(timeout=SERVE_WAIT)
    port = httpd.server_address[1]
    wrappers = _reset_counts()
    try:
        codes = {}
        codes["bin"], out = _http(port, "POST", "/classify", body)
        _same_answers("http POST /classify, 8 images (bin)", json.loads(out), want0)
        codes["png"], out = _http(port, "POST", "/classify", png.getvalue(),
                                  {"Content-Type": "image/png"})
        _same_answers("http POST /classify, one PNG", json.loads(out), want_png)
        codes["deadline"], out = _http(port, "POST", "/classify", body, {"X-Deadline-Ms": "0"})
        codes["healthz"], health = _http(port, "GET", "/healthz")
        codes["metrics"], metrics = _http(port, "GET", "/metrics")
        codes["reload"], out = _http(port, "POST", "/reload", json.dumps({"weights": w1}))
        codes["after reload"], out = _http(port, "POST", "/classify", body)
        _same_answers("http POST /classify after /reload to seed 1", json.loads(out), want1)
        batches = server.stats.batches
    finally:
        httpd.shutdown()
        t.join(timeout=SERVE_WAIT)
    if t.is_alive():
        raise RuntimeError("the HTTP daemon did not stop")
    launches = _expect_counts(wrappers, {"ln_qkv_attn": 12 * batches,
                                         "out_ln_mlp_residual": 12 * batches,
                                         "layer_norm": batches},
                              f"serve_http (bf16 fused, {batches} batches)")
    health = json.loads(health)
    names = sorted({ln.split("{")[0].split()[0] for ln in metrics.decode().splitlines()
                    if ln and not ln.startswith("#")})
    log(f"http codes {codes}; /healthz {health}; /metrics names {names}")
    want_codes = {"bin": 200, "png": 200, "deadline": 504, "healthz": 200, "metrics": 200,
                  "reload": 200, "after reload": 200}
    if codes != want_codes or batches != 3 or health["requests"] != 2 \
            or health["deadline_expired"] != 1 or names != METRIC_NAMES:
        raise RuntimeError(f"http daemon: codes {codes} (want {want_codes}), {batches} batches, "
                           f"/healthz {health}, metric names {names}")

    # the rollout's chain under TF32 settings: true fp32, against float64
    engine = InferenceEngine(VIT_B_16, params, "float32", "fused", dev)
    x = synth_images(2, VIT_B_16, seed=4)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        roll = engine.attention_maps(x, rollout=True).cpu().numpy()
        probs = engine.attention_maps(x)
        a32 = probs.mean(dim=2)
        a32 = 0.5 * a32 + 0.5 * torch.eye(a32.shape[-1], device=dev)
        a32 = a32 / a32.sum(-1, keepdim=True)
        r32 = torch.eye(a32.shape[-1], device=dev).expand(a32.shape[1:])
        for layer in a32:
            r32 = torch.matmul(layer, r32)  # TF32 under "high"
        tf32 = r32[:, 0, 1:].cpu().numpy().reshape(roll.shape)
    finally:
        torch.set_float32_matmul_precision(before)
    a = probs.double().cpu().mean(dim=2)
    t_ = a.shape[-1]
    a = 0.5 * a + 0.5 * torch.eye(t_, dtype=torch.float64)
    a = a / a.sum(-1, keepdim=True)
    r = torch.eye(t_, dtype=torch.float64).expand(a.shape[1:])
    for layer in a:
        r = layer @ r
    want = r[:, 0, 1:].numpy().reshape(roll.shape)
    # random weights attend nearly uniformly, so the map's values are ~1/T
    # and 1e-5 absolute is loose: hold it to 1e-5 of its largest value too
    # (a TF32 chain's 10-bit mantissa, ~1e-3 relative a product, is printed
    # beside it)
    scale = float(np.abs(want).max())
    d, d_tf32 = float(np.abs(roll - want).max()), float(np.abs(tf32 - want).max())
    rows = float((probs.sum(-1) - 1).abs().max())
    log(f"rollout fp32 on the card under set_float32_matmul_precision('high'), 2 images "
        f"{roll.shape}, largest value {scale:.6g}: max|d| vs float64 composition {d:.6g} "
        f"({d / scale:.3g} of the largest; tol 1e-5 and 1e-5 of it); a TF32 matmul chain on the "
        f"same probabilities {d_tf32:.6g} ({d_tf32 / scale:.3g}); probability rows sum to 1 "
        f"within {rows:.3g}")
    shape = (VIT_B_16.depth, 2, VIT_B_16.num_heads, VIT_B_16.seq_len, VIT_B_16.seq_len)
    if not (d <= 1e-5 and d <= 1e-5 * scale and rows <= 1e-5 and tuple(probs.shape) == shape):
        raise RuntimeError("rollout outside 1e-5 of the float64 composition")
    return launches


def group_serve(dev, card, summary, launches) -> None:
    """Phases 39-41."""
    from vit_tpu_torch.config import VIT_B_16

    params = synth_params(VIT_B_16, 0)
    launches.update(phase_server(params, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        phase_serve_selftest(params, dev, card, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        launches["serve_http"] = phase_serve_http(params, dev, card, workdir)


PHASES = ("classify", "train", "regularized", "long", "quant", "tome", "dh80", "per_op", "adamw",
          "parallel", "serve")


def group_classify(dev, card, summary, launches) -> None:
    """Phases 3-6."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.ops.kernels import _build

    summary.update(phase_kernels(kernel_cases(dev), KERNELS, 100))
    phase_gemm_core(dev, card)
    phase_wgrad_splits(dev, card)
    torch.cuda.empty_cache()
    params = synth_params(VIT_B_16, 0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["classify"] = phase_cli(params, workdir)
    images = synth_images(100, VIT_B_16, seed=1)
    phase_correctness(params, images, dev)
    phase_throughput(params, images, dev, card)


def group_train(dev, card, summary, launches) -> None:
    """Phases 7-10."""
    from vit_tpu_torch.ops.kernels import _build

    summary.update(phase_kernels(train_kernel_cases(dev), TRAIN_KERNELS, 64))
    phase_k7_shares_k8(dev)
    phase_k9_shares_k7(dev)
    phase_k5_split(dev, card)
    phase_k6_split(dev, card)
    phase_k4_split(dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train"] = phase_train_cli(workdir)
    phase_train_correctness(dev)
    torch.cuda.empty_cache()
    phase_train_throughput(dev, card)


def group_regularized(dev, card, summary, launches) -> None:
    """Phases 11-14."""
    from vit_tpu_torch.ops.kernels import _build

    summary.update(phase_kernels(reg_kernel_cases(dev), REG_KERNELS, 64))
    phase_regularizer_checks(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_regularized"] = phase_train_cli(
            workdir, REG_FLAGS, ("ln_qkv_attn", "ln_qkv_attn_bwd", *REG_KERNELS))
    phase_reg_correctness(dev)
    torch.cuda.empty_cache()
    phase_reg_throughput(dev, card)


def group_long(dev, card, summary, launches) -> None:
    """Phases 15-19."""
    summary.update(phase_kernels(long_kernel_cases(dev), LONG_KERNELS, LONG_BATCHES[0]))
    phase_k13_edges(dev)
    phase_k9_split(dev, card)
    torch.cuda.empty_cache()
    launches["classify_long"] = phase_long_inference(dev)
    torch.cuda.empty_cache()
    launches["train_long"] = phase_long_train(dev)
    torch.cuda.empty_cache()
    phase_long_throughput(dev, card)
    torch.cuda.empty_cache()
    phase_switch(dev, card)


def group_quant(dev, card, summary, launches) -> None:
    """Phases 20-24."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.ops.kernels import _build

    summary.update(phase_quant_kernels(quant_kernel_cases(dev)))
    phase_k15_split(dev, card)
    phase_k16_split(dev, card)
    phase_k17_split(dev, card)
    phase_int8_gemm(dev, card)
    torch.cuda.empty_cache()
    params = synth_params(VIT_B_16, 0)
    images = synth_images(100, VIT_B_16, seed=1)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["classify_quant"] = phase_cli(
            params, workdir, "quant", ("ln_qkv_attn_q8", "out_ln_mlp_residual_q8"))
    phase_quant_correctness(params, images, dev)
    torch.cuda.empty_cache()
    launches["classify_quant_long"] = phase_quant_long(dev)
    torch.cuda.empty_cache()
    phase_quant_throughput(params, images, dev, card)


def group_tome(dev, card, summary, launches) -> None:
    """Phases 25 and 27-30."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.ops.kernels import _build

    cases, labels = tome_kernel_cases(dev)
    summary.update(phase_kernels(cases, labels, 64))
    del cases
    phase_quant_kernels(tome_quant_cases(dev), {"ln_qkv_attn_q8+hooks": ("K15 log_size kmean",)})
    torch.cuda.empty_cache()
    params = synth_params(VIT_B_16, 0)
    tome = ["--tome", str(TOME_R)]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["classify_tome"] = phase_cli(
            params, workdir, "fused", ("ln_qkv_attn", "out_residual", "ln_mlp_residual"), tome, 0)
        launches["classify_quant_tome"] = phase_cli(
            params, workdir, "quant", ("ln_qkv_attn_q8", "out_residual", "ln_mlp_residual_q8"),
            tome, 0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_tome"] = phase_tome_train_cli(workdir, [], (
            "ln_qkv_attn", "out_residual", "ln_mlp_residual", "ln_qkv_attn_bwd",
            "out_residual_bwd", "ln_mlp_residual_bwd"))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_tome_regularized"] = phase_tome_train_cli(workdir, REG_FLAGS, (
            "ln_qkv_attn", "out_residual_train", "ln_mlp_residual_train", "ln_qkv_attn_bwd",
            *TOME_KERNELS))
    torch.cuda.empty_cache()
    images = synth_images(100, VIT_B_16, seed=1)
    phase_tome_correctness(params, images, dev)
    torch.cuda.empty_cache()
    phase_tome_throughput(params, images, dev, card)


def group_dh80(dev, card, summary, launches) -> None:
    """Phase 26."""
    cases, labels, q8 = dh80_cases(dev)
    phase_kernels(cases, labels, H14["batch"])
    phase_quant_kernels(q8, labels)


def group_per_op(dev, card, summary, launches) -> None:
    """Phases 31-33."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.ops.kernels import _build

    cases, labels = per_op_kernel_cases(dev)
    summary.update(phase_kernels(cases, labels, 100))
    del cases
    phase_k22_split(dev, card)
    torch.cuda.empty_cache()
    params = synth_params(VIT_B_16, 0)
    per_op = tuple(PER_OP_KERNELS)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["classify_per_op"] = phase_cli(params, workdir, "per_op", per_op, (), 25)
        profiled = {name: 12 * PROFILE_ITERS for name in per_op}
        phase_cli(params, workdir, "per_op", per_op, ["--profile"], 25, profiled)
        phase_cli(params, workdir, "fused", more=profiled, extra=["--profile"])
    images = synth_images(100, VIT_B_16, seed=1)
    launches["classify_per_op_long"] = phase_per_op_correctness(params, images, dev)
    torch.cuda.empty_cache()
    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    _inference_rates(VIT_B_16, params, x, ("per_op", "fused", "eager"), dev, card,
                     "per_op throughput", 4)


def group_adamw(dev, card, summary, launches) -> None:
    """Phases 34-35."""
    from vit_tpu_torch.ops.kernels import _build

    summary.update(phase_adamw_kernel(dev, card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_fused_adamw"] = phase_adamw_train_cli(workdir)
    torch.cuda.empty_cache()
    _train_rates(dev, card, {"fused_train fused_adamw": ("fused_train", False, 0, "fused_adamw"),
                             "fused_train adamw": ("fused_train", False)},
                 "fused AdamW train throughput")


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Drive the port on one NVIDIA card and check it.")
    p.add_argument("--only", metavar="PHASE[,PHASE]",
                   help=f"run only these groups of phases, of {', '.join(PHASES)} (a rerun; "
                   "without it every phase runs)")
    p.add_argument("--rank-worker", metavar="DIR",
                   help="run one rank of phase 38 (torchrun starts these), writing into DIR")
    args = p.parse_args(argv)
    if args.rank_worker:
        rank_worker(args.rank_worker)
        return
    only = PHASES if args.only is None else tuple(args.only.split(","))
    if not set(only) <= set(PHASES):
        p.error(f"--only takes {', '.join(PHASES)}; got {args.only}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs an NVIDIA card")
    from vit_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    reused = _build.library_path().exists()
    _build.load_library()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({'reused' if reused else 'built'} {_build.library_path().name})")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    summary, launches = {}, {}
    groups = {"classify": group_classify, "train": group_train, "regularized": group_regularized,
              "long": group_long, "quant": group_quant, "tome": group_tome, "dh80": group_dh80,
              "per_op": group_per_op, "adamw": group_adamw, "parallel": group_parallel,
              "serve": group_serve}
    for name in PHASES:
        if name in only:
            t0 = time.perf_counter()
            groups[name](dev, card, summary, launches)
            torch.cuda.empty_cache()
            log(f"phases {name}: {time.perf_counter() - t0:.3f} s")

    # launches: the classify CLI's run for K1-K3, the train CLI's for K4-K7,
    # the regularized train CLI's for K10-K12a, the long classify forward's
    # for K13, the long train step's for K14, K8, K9, the quant classify
    # CLI's for K15 and K16, the ToMe quant classify CLI's for K17, the long
    # quant forward's for K15's stages 1-2, the regularized ToMe train CLI's
    # for K12b and K12c, the per-op classify CLI's for K21 and K22, the
    # fused AdamW train CLI's for K20, rank 0's of the quant --tp 2 CLI for
    # K18a and K18b, the kernel study's for K19; "paths" has every reading
    path_of = {**{k: "classify" for k in KERNELS}, **{k: "train" for k in TRAIN_KERNELS},
               **{k: "train_regularized" for k in REG_KERNELS},
               **{k: "train_long" for k in LONG_KERNELS}, "flash_attention_fwd": "classify_long",
               **{k: "classify_quant" for k in QUANT_KERNELS}, "ln_qkv_q8": "classify_quant_long",
               "ln_mlp_residual_q8": "classify_quant_tome",
               **{k: "train_tome_regularized" for k in TOME_KERNELS},
               **{k: "classify_per_op" for k in PER_OP_KERNELS},
               **{k: "train_fused_adamw" for k in ADAMW_KERNELS},
               **{k: "classify_quant_tp" for k in TP_KERNELS},
               **{k: "kernel_study" for k in STUDY_KERNELS}}
    all_kernels = {**KERNELS, **TRAIN_KERNELS, **REG_KERNELS, **LONG_KERNELS, **QUANT_KERNELS,
                   **TOME_KERNELS, **PER_OP_KERNELS, **ADAMW_KERNELS, **TP_KERNELS,
                   **STUDY_KERNELS}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches.get(path_of[name], {}).get(name),
         "paths": {path: counts[name] for path, counts in launches.items()}, **summary[name]}
        for name, (_, src, replaces) in all_kernels.items() if name in summary
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
