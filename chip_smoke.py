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
     time limit (``--rank-worker``), at B/16 widths and depth 2
     (``vit_b_16_depth2``: the ranks' time is gloo's, a fixed cost a
     layer): the classify CLI with ``--ops quant --tp 2`` (2 K15, 2 K18a, 2
     K18b, 1 K3 per rank), ``--ops fused --tp 2`` (2 K1, 2 K5 partial, 1 K3)
     and ``--ops fused --dp 2`` (2 K1 and 2 K2 on 50 images each), counts
     set to 0 just before and read just after on every rank; their result
     lines against the single-card CLI's by the comparator rule; fp32
     ``fused`` tp 2 and dp 2 logits within 1e-4 of the single card's; the
     time per forward of two ranks sharing one card; the tensor-parallel
     forward @512 batch 16 (2 K13, 2 K5 partial, 1 K3 per rank).

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

 42. MAE pretraining (decoder 512,8,16; B/16 encoder on the 49 visible
     patches): the loss and every leaf's gradient, encoder and decoder,
     fp32 ``fused_train`` against eager on 4 images with the same masks
     (1e-3 x max(1, max|g|)), the bf16 mixed loss against fp32 (2e-2); the
     train CLI with ``--mae --save-backbone`` (20 each of K1, K4, K5, K6,
     K7 per step: 12 encoder and 8 decoder blocks; no K2 or K3), then
     ``--init-weights`` of the saved backbone for 2 steps (12 each); the MAE
     step's img/s at batch 64 bf16 mixed, ``fused_train`` and eager in
     turns beside the supervised ``fused_train`` step, with peak memory;
     one MAE ``fused_train`` step in a profiler trace (device time by
     kernel, busy share);
 43. DeiT distillation (``deit_b_16`` student; teacher ``vit_b_16`` from
     ``init_params`` seed 1, as an .npz): the fused teacher's fp32 logits
     against the eager teacher's; hard and soft (tau 2) distillation's loss
     and every leaf's gradient, both heads, fp32 ``fused_train`` against
     eager on one set of teacher logits; the train CLI with
     ``--distill-teacher`` (the student's 12 each of K1, K4-K7, the fused
     teacher's 12 K1, 12 K2, 1 K3 per step) and with
     ``--distill-teacher-int8`` (the teacher's 12 K15, 12 K16, 1 K3); the
     step's img/s with either teacher beside the plain ``deit_b_16`` step;
 44. QAT: the train CLI with ``--ops qat`` at AdamW 1e-4 (no kernel
     launches; the loss falls over 3 steps); QAT then deploy: the fp32
     ``qat`` forward against the fp32 ``quant`` kernels' (12 K15, 12 K16,
     1 K3) on the same weights at batch 100, by the comparator rule; the
     QAT step's img/s beside the eager step's.  TF32 is off throughout.
 45. parallel training (in the parallel group, after 38): K8
     ``ln_mlp_residual_bwd(residual=False)`` (the tensor-parallel form)
     against its twin at rank 0's shard of B/16's MLP for tp 2 and 4 (F/tp
     1,536 and 768) at b16 x T 197 rows, bf16 and fp32, timed, with device
     time and bound; then two ranks sharing the card over gloo, started by
     ``torchrun`` with a time limit (``--rank-train-worker``), at B/16
     widths and depth 2 as phase 38: the fp32 gradients of one tp 2 step
     @224 batch 16, gathered, against the single-card ``fused_train``
     step's (1e-3 x max(1, max|g|) per leaf); the train CLI (``--ops
     fused_train``) with ``--tp 2`` batch 16, bf16 mixed and fp32, 3 steps
     (2 K1, 2 K5 partial, 2 K6, 2 K8 ``residual=False`` per rank and step;
     no K2, K4 or K7), ``--dp 2`` batch 32 bf16 with ``--optimizer
     fused_adamw``, 3 steps (2 each of K1, K4-K7 and 1 K20; the params of
     both ranks equal bit for bit after), ``--dp 2 --dropout 0.1``, 1 step
     (2 K1, K10, K11, K12a, K6), ``--dp 2 --mae`` (10 each of K1, K4-K7: 2
     encoder and 8 decoder blocks) and ``--dp 2 --config deit_b_16_depth2
     --distill-teacher`` (a depth-2 ``vit_b_16`` teacher), 2 steps each,
     every count set to 0 just before and read just after on every rank;
     the tp 2 step @512 batch 2 (2 K13, K14, K5 partial, K8
     ``residual=False`` per rank); the time per step of two ranks sharing
     one card (not a scaling figure).

 46. data and evaluation: the native reader built from ``native/vitio.cpp``
     (``vit_tpu_torch/io/native.py``); 256 B/16 @224 images in 3 shards with
     label files (the fp32 ``eager`` engine's top-1), read through the
     native gather reader and through numpy memmaps, bit for bit the written
     images; ``vit-tpu-torch-eval --data-dir`` bf16 at batch 100 (100, 100
     and a ragged 56) on ``--ops fused`` (12 K1, 12 K2, 1 K3 per batch),
     ``--ops quant`` (12 K15, 12 K16, 1 K3) and ``--tome 13`` (12 K1, 12 K4,
     12 K5), counts set to 0 just before and read just after, each run's
     top-1 and top-5 those of the same engine's ``classify`` on the same
     batches; ``--image-dir`` over 4 class folders of 8 PNGs at 256 x 320;
     the shards' evaluation streamed through ``prefetch_to_device`` against
     the same batches already on the card, in turns; the train CLI with
     ``--data-dir`` (B/16 batch 64, ``fused_train``, ``--optimizer
     fused_adamw``, 3 steps; 12 each of K1, K4-K7 and 1 K20 per step) and
     ``--eval-data-dir --eval-every 2 --eval-batches 1``, its step times
     beside the static-batch CLI's; the oracle's float64 logits on 4 images
     against fp32 ``eager`` and ``fused`` on the card (1e-3); the profiler's
     ``roofline`` and ``forward_timing`` of the batch-100 ``fused`` forward
     and ``train_step_timing`` of the batch-64 step.

 47. the training loop's state and recipe: the train CLI (B/16 batch 64
     ``fused_train``, bf16 mixed, ``--optimizer fused_adamw``) on 256 B/16
     images in 3 shards with ``--augment crop,flip,mixup,cutmix --ema-decay
     0.999 --eval-data-dir``: 4 steps straight with ``--save-state
     --save-every 2``, then the same run sent SIGTERM in its second step
     (checkpointed at step 2, rc 0) and resumed for 2 steps, the two final
     archives and EMA sidecars equal leaf for leaf, bit for bit, where two
     planted resumes (draws restarted at step 0; no EMA sidecar) are not
     (12 each of K1, K4-K7
     and 1 K20 per step, counts set to 0 just before each run and read just
     after); ``--freeze-backbone --grad-clip 1`` (the backbone the init bit
     for bit, 12 each of K1, K4-K7 per step), ``--skip-nonfinite`` on a
     static batch pair whose second holds NaNs (steps 1 and 3 skipped, the
     archive's counters (1, False, 2) and adam count 2); two ranks over
     gloo (``--rank-recipe-worker``): a tp 2 save and a tp 2 resume of the
     one-card archive at depth 2, fp32, both against the one-card runs'
     archives (params and EMA by the L2 norm of the difference against
     that of the move, moments by their largest difference), bounds that a
     planted one-card step on another batch breaks; the recipe step's wall and device time beside the plain
     step's, the augmentation's and the EMA's device time, and the time to
     write a B/16 train state.

 48. pipeline and sequence parallelism, ranks sharing the card over gloo
     (``torchrun`` with a time limit, ``--rank-pp-sp-worker``; counts set to
     0 just before each run and read just after, on every rank): the cyclic
     shift bit for bit in fp32 and bf16 (signed zero, inf, NaN); two ranks:
     the pp 2 ``fused`` forward @224 b100 bf16 in 4 microbatches (24 K1 and
     24 K2 per rank: 6 layers x 4 microbatches) against the one-card
     ``fused`` engine (0.027, and the comparator rule); the train CLI with
     ``--pp 2 --microbatches 4`` fp32 b16 (24 each of K1, K4-K7 per rank and
     step), ``--pp 2 --microbatches 1 --dropout 0.1 --drop-path 0.1`` (6
     each of K1, K10, K11, K12a, K6) and ``--sp 2`` bf16 mixed (12 each of
     K4, K5, K8, K9), their losses against the one-card CLI's; the fp32
     gradients of one pp 2 step (plain and regularized, the masks of the
     one-card step's seeds) and one sp 2 ``fused_train`` step, gathered,
     against the one-card ``fused_train`` and eager steps' (1e-3 x max(1,
     max|g|), loss 1e-4); the sp 2 bf16 mixed loss @224 b16 and @512 b2
     (513 tokens a shard) against the one-card eager step's (2e-2); the sp
     2 eager fp32 forward against the one-card forward (1e-4); four ranks:
     pp 2 x tp 2 at depth 4, the ``quant`` forward bf16 b16 (4 each of K15,
     K18a, K18b per rank) by the comparator rule and the ``fused_train``
     gradients (4 each of K1, K5 partial, K6, K8 ``residual=False``); the pp
     forward's and the pp and sp steps' wall and device ms beside the one
     card's (two ranks sharing one card: not scaling figures).

 49. serving over a mesh, two ranks sharing the card over gloo (``torchrun``
     with a time limit, ``--rank-serve-mesh-worker``; counts set to 0 just
     before each run and read just after, on every rank): the
     ``InferenceServer`` over tp 2 ``fused`` (12 K1 at the local heads, 12
     K5 partial, 1 K3 per rank and batch), tp 2 ``quant`` (12 K15, 12 K18a,
     12 K18b, 1 K3) and dp 2 ``fused`` (12 K1, 12 K2, 1 K3) on 64 requests
     of phase 39's stream (max_batch 64, batch_pad 32; rank 0 serves, rank 1
     follows: warmup's two padded sizes and every batch on both ranks), each
     answer against the one-card engine's classify of that request alone by
     phase 38's comparator rule, and fp32 tp 2 on 8 requests (probabilities
     within 1e-4); the dp 2 ``LockstepServer`` (local_batch 32, 10 ms ticks):
     one second with no traffic launches nothing, each rank's 24 requests of
     its own seed answered from its own rows (12 K1, 12 K2, 1 K3 per rank and
     tick), rank 1 stops while rank 0 has 10 requests queued and all 10 are
     answered; the serve CLI's daemon with ``--tp 2`` (rank 0 answers POST
     /classify, POST /reload to seed-1 weights, then the seed-1 one-card
     engine's answers); the serve CLI with ``--multihost`` on two processes
     joined by explicit ``--coordinator``/``--num-processes``/``--process-id``
     (not torchrun), each daemon on ``--port 0``: POST /classify of 8 images
     to each against the one-card engine, POST /reload answered 409, SIGTERM
     drains both; the train CLI with ``--multihost`` on two such processes
     (depth 2, bf16 mixed ``fused_train``, 3 steps on 256 images in 3 shards:
     2 each of K1, K4-K7 per process and step), its losses those of the
     ``--dp 2`` torchrun run; img/s, p50 and p99 of each server beside the
     one-card server's on the same 64 requests (two ranks sharing one card:
     not scaling figures).

``--only PHASE[,PHASE]`` reruns groups of phases (classify 3-6, train 7-10,
regularized 11-14, long 15-19, quant 20-24, tome 25 and 27-30, dh80 26,
per_op 31-33, adamw 34-35, parallel 36-38 and 45, serve 39-41, mae 42,
distill 43, qat 44, data 46, recipe 47, pp_sp 48, serve_mesh 49); without it
every phase runs.

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
import os
import re
import statistics
import subprocess
import tempfile
import threading
import time
import unittest.mock

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
# phases 38 and 45 run their rank runs at B/16 widths and depth 2 (the ranks
# spend their time in gloo's host all-reduces, a fixed cost a layer)
RANK_DEPTH = 2
RANK_CONFIG, RANK_DEIT_CONFIG = "vit_b_16_depth2", "deit_b_16_depth2"
RANKS_TIMEOUT = 420  # s: a rank that hangs fails phase 38
TRAIN_RANKS_TIMEOUT = 300  # s: a rank that hangs fails phase 45
# phase 45: K8's tensor-parallel form, a kernels-line entry of its own (its
# launches are K8's count on the tensor-parallel train paths)
K8_PARTIAL_KERNELS = {
    "ln_mlp_residual_bwd residual=False": ("K8 residual=False",
                                           "vit_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
                                           "vit_tpu/ops/pallas/backward.py:218"),
}
K8_PARTIAL_ROWS = 16 * 197  # b16 x T 197: a tp 2 train step's rows at @224
TP_TRAIN_BATCH, DP_TRAIN_BATCH = 16, 32
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
              more=None, config: str = "vit_b_16", depth: int = 12) -> dict:
    """Phases 4, 21, 27 and 32 (and phase 38's references): the classify
    CLI on the card with ``--config config --ops ops`` and ``extra`` flags,
    on ``params`` saved as an npz: ``depth`` launches of each of
    ``kernels``, ``final_ln`` of K3, ``more`` ({kernel: launches}) on top,
    none of any other; with ``--profile`` among ``extra``, the six phase
    lines of ``phase_report``.  -> launch counts of its run."""
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
            "--config", config, "--weights", weights, "--synth", "100", "--ops", ops,
            "--dtype", "bfloat16", "--device", "cuda", "--batch-pad", "100", "--json",
            "--output", result, *extra,
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
    want.update({name: depth for name in kernels}, layer_norm=final_ln)
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
    torch.profiler trace (``_profile_call``)."""
    from vit_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(cfg, params, "bfloat16", ops, dev, batch_pad=x.shape[0],
                             tome_r=tome_r)
    what = f"{ops} ToMe r={tome_r}" if tome_r else ops
    _profile_call(lambda: engine.logits(x), f"{what} {cfg.name} batch {x.shape[0]} bf16",
                  "forward", card)


def _profile_call(fn, what: str, unit: str, card: str) -> None:
    """One call of ``fn`` (after one warm-up call) in a torch.profiler
    trace: its wall time, its kernels' device time by name (annotations on
    the device timeline not counted, as in ``_device_ms``) and the device's
    busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    log(f"profile {what}: {unit} {wall:.6g} ms wall (profiler "
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


def _train_cli(workdir: str, extra, steps: int = TRAIN_STEPS, records=None, logged=None,
               finite: bool = True) -> tuple:
    """The train CLI on the card (B/16, ``steps`` steps, batch 64,
    fused_train, bf16 mixed) with ``extra`` flags (a later flag overrides
    an earlier one); every count set to 0 just before and read just after.
    -> (launch counts, losses); ``records`` (a list) gets every record of
    its ``--log-jsonl``.  It must log ``logged`` losses (default
    ``steps``), all finite unless ``finite`` is False."""
    from vit_tpu_torch.cli.train import main

    fd, log_path = tempfile.mkstemp(prefix="train", suffix=".jsonl", dir=workdir)
    os.close(fd)
    buf = io.StringIO()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--config", "vit_b_16", "--steps", str(steps), "--batch", "64",
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
        logged_records = [json.loads(line) for line in fh]
    if records is not None:
        records.extend(logged_records)
    losses = [r["loss"] for r in logged_records if "loss" in r]
    want = steps if logged is None else logged
    if len(losses) != want or (finite and not np.isfinite(losses).all()):
        raise RuntimeError(f"train CLI {extra} logged {losses}, expected {want} finite losses")
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

    return _step_rates({label: (lambda spec=spec: make(*spec)) for label, spec in runs.items()},
                       b, phase, base.name, card)


def _step_rates(makers: dict, b: int, phase: str, model: str, card: str) -> tuple:
    """Train img/s of each run ``label: factory`` (the factory returns a
    step of ``b`` images that waits for the device), timed in turns, and
    the peak device memory of each alone on the card."""
    peak = {}
    for label, make in makers.items():  # alone on the card, for its peak
        run = make()
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        del run
        torch.cuda.empty_cache()
    steps = {label: make() for label, make in makers.items()}
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
        log(f"{phase} {label} {model} batch {b} bf16 mixed: {rate:.6g} img/s "
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
                          {"ln_qkv_attn_q8": RANK_DEPTH, "ln_fc1_gelu_q8": RANK_DEPTH,
                           "fc2_q8_partial": RANK_DEPTH, "layer_norm": 1}),
    "classify_tp": (["--ops", "fused", "--tp", "2"],
                    {"ln_qkv_attn": RANK_DEPTH, "ln_mlp_residual": RANK_DEPTH, "layer_norm": 1}),
    "classify_dp": (["--ops", "fused", "--dp", "2"],
                    {"ln_qkv_attn": RANK_DEPTH, "out_ln_mlp_residual": RANK_DEPTH,
                     "layer_norm": 1}),
}
LONG_TP_LAUNCHES = {"flash_attention_fwd": RANK_DEPTH, "ln_mlp_residual": RANK_DEPTH,
                    "layer_norm": 1}
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
    the tensor-parallel forward @512 batch 16 with its counts; all at B/16
    widths and depth 2.  Writes ``rank<r>.json`` (and, on rank 0, the
    logits) into ``workdir``."""
    import torch.distributed as dist

    from vit_tpu_torch.cli.main import main as classify
    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _register_tp_config()
    cfg = get_config(RANK_CONFIG)
    weights = f"{workdir}/params.npz"
    report = {"rc": {}, "launches": {}, "stdout": {}, "ms": {}}
    real_k1, k1_spy = k1.ln_qkv_attn, _RowSpy(k1.ln_qkv_attn)
    for path, (flags, _) in RANK_RUNS.items():
        buf = io.StringIO()
        wrappers = _reset_counts()
        k1.ln_qkv_attn = k1_spy if path == "classify_dp" else real_k1
        with contextlib.redirect_stdout(buf):
            rc = classify(["--config", RANK_CONFIG, "--weights", weights, "--synth", "100",
                           "--dtype", "bfloat16", "--device", "cuda", "--batch-pad", "100",
                           "--json", "--dist-backend", "gloo", "--output",
                           f"{workdir}/{path}.txt", *flags])
        k1.ln_qkv_attn = real_k1
        report["rc"][path] = rc
        report["launches"][path] = {name: fn.launches for name, fn in wrappers.items()}
        out = buf.getvalue().splitlines()
        report["stdout"][path] = out[:2] + out[-2:]
    report["k1_rows_dp"] = k1_spy.rows
    rank, dev = dist.get_rank(), torch.device("cuda", torch.cuda.current_device())
    params = load_params_any(weights, cfg)
    images = synth_images(100, cfg, seed=0)  # the CLI's --synth 100
    logits = {}
    for name, (ops, dtype, axes) in RANK_ENGINES.items():
        eng = InferenceEngine(cfg, params, dtype, ops, dev, batch_pad=100,
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
    cfg = cfg.with_image_size(LONG_IMAGE)
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
    with a time limit (a rank that hangs, or fails, fails the phase), at
    B/16 widths and depth 2 (``params``, ``RANK_CONFIG``):
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

    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    _register_tp_config()
    cfg = get_config(RANK_CONFIG)
    refs = {}
    for ops, kernels in (("quant", ("ln_qkv_attn_q8", "out_ln_mlp_residual_q8")),
                         ("fused", ("ln_qkv_attn", "out_ln_mlp_residual"))):
        # saves params.npz, writes result.txt
        phase_cli(params, workdir, ops, kernels, config=RANK_CONFIG, depth=RANK_DEPTH)
        refs[ops] = f"{workdir}/single_{ops}.txt"
        os.replace(f"{workdir}/result.txt", refs[ops])
    images = synth_images(100, cfg, seed=0)  # the CLI's --synth 100
    f32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=100)
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
        if rep["k1_rows_dp"] != [50 * B16["t"]] * RANK_DEPTH:
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
        log(f"{name} B/16 widths depth {RANK_DEPTH} batch 100: {ms:.6g} ms per forward, {RANKS} "
            f"ranks sharing one card "
            f"over gloo (not a scaling figure); {card}")
    return {path: reports[0]["launches"][path] for path in (*RANK_RUNS, "classify_tp_long")}


# phase 45's runs, per rank and step: name -> (train CLI flags, steps,
# launches per step, K5 partial, K8 residual=False)
_DEPTH_STEP = {name: RANK_DEPTH for name in ("ln_qkv_attn", "ln_mlp_residual", "ln_qkv_attn_bwd",
                                              "ln_mlp_residual_bwd")}
TRAIN_RANK_RUNS = {
    "train_tp": (["--tp", "2", "--batch", str(TP_TRAIN_BATCH), "--mixed-precision"], 3,
                 _DEPTH_STEP, True),
    "train_tp_fp32": (["--tp", "2", "--batch", str(TP_TRAIN_BATCH)], 3, _DEPTH_STEP, True),
    "train_dp": (["--dp", "2", "--batch", str(DP_TRAIN_BATCH), "--mixed-precision",
                  "--optimizer", "fused_adamw"], 3,
                 {"ln_qkv_attn": RANK_DEPTH, "out_residual": RANK_DEPTH,
                  "ln_mlp_residual": RANK_DEPTH, "ln_qkv_attn_bwd": RANK_DEPTH,
                  "ln_mlp_out_residual_bwd": RANK_DEPTH, "adamw_update": 1}, False),
    "train_dp_regularized": (["--dp", "2", "--batch", str(DP_TRAIN_BATCH), "--mixed-precision",
                              "--dropout", str(REG_P)], 1,
                             {"ln_qkv_attn": RANK_DEPTH, "out_residual_train": RANK_DEPTH,
                              "ln_mlp_residual_train": RANK_DEPTH,
                              "ln_mlp_out_residual_bwd_train": RANK_DEPTH,
                              "ln_qkv_attn_bwd": RANK_DEPTH}, False),
    # the encoder's blocks and the decoder's 8
    "train_mae_dp": (["--dp", "2", "--batch", str(DP_TRAIN_BATCH), "--mixed-precision", "--mae"],
                     2, {name: RANK_DEPTH + 8 for name in ("ln_qkv_attn", *TRAIN_KERNELS)},
                     False),
    # the student's blocks and the fused teacher's
    "train_distill_dp": (["--dp", "2", "--batch", str(DP_TRAIN_BATCH), "--mixed-precision",
                          "--config", RANK_DEIT_CONFIG, "--distill-teacher", "TEACHER",
                          "--distill-config", RANK_CONFIG], 2,
                         {"ln_qkv_attn": 2 * RANK_DEPTH, "out_ln_mlp_residual": RANK_DEPTH,
                          "layer_norm": 1, **{name: RANK_DEPTH for name in TRAIN_KERNELS}},
                         False),
}
TP_LONG_TRAIN_STEP = {"flash_attention_fwd": RANK_DEPTH, "flash_attention_bwd": RANK_DEPTH,
                      "ln_mlp_residual": RANK_DEPTH, "ln_mlp_residual_bwd": RANK_DEPTH}


class _FlagSpy(_RowSpy):
    """A kernel wrapper that records the value of one keyword of each call
    (``default`` where it is not passed)."""

    def __init__(self, fn, flag: str, default: bool):
        super().__init__(fn)
        self.flag, self.default, self.values = flag, default, []

    def __call__(self, *args, **kwargs):
        self.values.append(bool(kwargs.get(self.flag, self.default)))
        return self.fn(*args, **kwargs)


def _train_rank_cli(workdir: str, flags, steps: int, mesh_spies,
                    config: str = "vit_b_16") -> dict:
    """One phase 45 run of the train CLI on this rank (its argument
    parsing, mesh, setup and loop: ``vit_tpu_torch.cli.train.main`` in
    pieces, so that the params stay readable), every count set to 0 just
    before the loop and read just after.  -> the rank's report."""
    import hashlib

    import torch.distributed as dist

    from vit_tpu_torch.cli.train_args import build_parser
    from vit_tpu_torch.cli.train_loop import run
    from vit_tpu_torch.cli.train_setup import build_mesh, prepare
    from vit_tpu_torch.runtime.trainer import leaves

    argv = ["--config", config, "--steps", str(steps), "--ops", "fused_train",
            "--device", "cuda", "--dist-backend", "gloo", "--log-jsonl", f"{workdir}/log.jsonl",
            *flags]
    args = build_parser().parse_args(argv)
    mesh, device = build_mesh(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = prepare(args, mesh, device)
        for spy in mesh_spies:
            spy.values.clear()
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        rc = run(args, st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    digest = hashlib.sha256()
    for t in leaves(st.params):
        digest.update(t.detach().cpu().numpy().tobytes())
    report = {"rc": rc, "launches": {name: fn.launches for name, fn in wrappers.items()},
              "flags": {spy.flag: [sum(spy.values), len(spy.values)] for spy in mesh_spies},
              "stdout": buf.getvalue().splitlines()[-3:], "wall_s": wall,
              "params_sha256": digest.hexdigest(), "rank": dist.get_rank()}
    if dist.get_rank() == 0:
        with open(f"{workdir}/log.jsonl") as fh:
            report["steps"] = [json.loads(line) for line in fh]
        os.remove(f"{workdir}/log.jsonl")
    return report


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def train_rank_worker(workdir: str) -> None:
    """One rank of phase 45 (``torchrun`` starts ``RANKS`` of them): the
    fp32 gradients of one tensor-parallel step, gathered; the train CLI
    runs of ``TRAIN_RANK_RUNS``; the tensor-parallel step @512 batch 2; all
    at B/16 widths and depth 2.  Writes ``train_rank<r>.json`` (and, on rank
    0, the gradients) into ``workdir``."""
    import torch.distributed as dist

    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.parallel.sharding import shard_params, unshard_params
    from vit_tpu_torch.runtime import distributed, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.initialize(backend="gloo")
    rank = dist.get_rank()
    _register_tp_config()
    cfg = get_config(RANK_CONFIG)
    # the flags of K5 and K8 on the tensor-parallel paths
    spies = [_FlagSpy(k5.ln_mlp_residual, "partial", False),
             _FlagSpy(k8.ln_mlp_residual_bwd, "residual", True)]
    k5.ln_mlp_residual, k8.ln_mlp_residual_bwd = spies
    report = {"runs": {}}

    # the fp32 gradients of one step (SGD at lr 0 keeps them), gathered
    mesh = make_mesh({"dp": 1, "tp": 2})
    x, y = _tp_grad_batch(dev)
    params = trainer.as_trainable(
        shard_params(vit.init_params(torch.Generator().manual_seed(0), cfg), mesh), dev)
    step = trainer.make_train_step_kernel_tp(cfg, torch.optim.SGD(
        list(trainer.leaves(params)), lr=0.0), mesh)
    report["tp_grad_loss"] = float(step(params, x, y))
    grads = unshard_params(_grad_tree(params), mesh)
    if rank == 0:
        np.savez(f"{workdir}/tp_grads.npz", **{p: g.cpu().numpy() for p, g in _paths(grads)})
    del params, grads, step
    torch.cuda.empty_cache()

    teacher = f"{workdir}/teacher.npz"
    for name, (flags, steps, _, _) in TRAIN_RANK_RUNS.items():
        flags = [teacher if f == "TEACHER" else f for f in flags]
        report["runs"][name] = _train_rank_cli(workdir, flags, steps, spies, RANK_CONFIG)
        torch.cuda.empty_cache()

    # the tensor-parallel step @512 batch 2: K13/K14 at the local heads
    cfg = cfg.with_image_size(LONG_IMAGE)
    params = trainer.as_trainable(
        shard_params(vit.init_params(torch.Generator().manual_seed(0), cfg), mesh), dev)
    step = trainer.make_train_step_kernel_tp(cfg, torch.optim.SGD(
        list(trainer.leaves(params)), lr=1e-4), mesh, compute_dtype=torch.bfloat16)
    xl = torch.from_numpy(synth_images(2, cfg, seed=5)).to(dev)
    yl = torch.arange(2, device=dev)
    for spy in spies:
        spy.values.clear()
    wrappers = _reset_counts()
    loss = float(step(params, xl, yl))
    torch.cuda.synchronize()
    report["runs"]["train_tp_long"] = {
        "rc": 0 if np.isfinite(loss) else 1,
        "launches": {n: fn.launches for n, fn in wrappers.items()},
        "flags": {spy.flag: [sum(spy.values), len(spy.values)] for spy in spies}, "loss": loss}
    with open(f"{workdir}/train_rank{rank}.json", "w") as fh:
        json.dump(report, fh)


def _tp_grad_batch(dev):
    """Phase 45's gradient batch: 16 synthetic B/16 images and labels."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images

    x = torch.from_numpy(synth_images(TP_TRAIN_BATCH, VIT_B_16, seed=3)).to(dev)
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 1000, TP_TRAIN_BATCH)).to(dev)
    return x, y


def k8_partial_cases(dev: torch.device):
    """-> ({kernel: [case]}, labels) for phase 45: K8 ``residual=False`` at
    rank 0's shard of B/16's MLP for tp 2 and 4 (F/tp 1,536 and 768) at
    b16 x T 197 rows, bf16 and fp32, against its twin, with device time."""
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8

    d, f = B16["d"], B16["f"]
    rn = _rand(dev, 45)
    name = next(iter(K8_PARTIAL_KERNELS))
    labels = {name: K8_PARTIAL_KERNELS[name]}
    cases = {name: []}

    def partial(*args):
        return k8.ln_mlp_residual_bwd(*args, residual=False)

    def partial_plain(*args):
        return k8.ln_mlp_residual_bwd_plain(*args, residual=False)

    rows = K8_PARTIAL_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        for tp in TP_SIZES:
            fl = f // tp
            args = (rn(rows, d, dtype=dtype), rn(rows, d, scale=2.0, dtype=dtype),
                    rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype),
                    rn(d, fl, scale=d ** -0.5, dtype=dtype), rn(fl, scale=0.1, dtype=dtype),
                    rn(fl, d, scale=fl ** -0.5, dtype=dtype), 1e-6, "exact")
            tag = f"{_tag(dtype, TP_TRAIN_BATCH, rows)} tp {tp} (rank 0: F/tp {fl})"
            cases[name].append(dict(
                case(tag, dtype, TP_TRAIN_BATCH, partial, partial_plain, args,
                     10 * rows * d * fl, device=True),
                summary=dtype == torch.bfloat16 and tp == 2))
    return cases, labels


def phase_parallel_train(dev: torch.device, card: str, workdir: str) -> dict:
    """Phase 45: parallel training.  K8 ``residual=False`` against its twin
    at tp 2 and 4 shard shapes; then two ranks sharing the card over gloo
    (``torchrun`` with a time limit, ``--rank-train-worker``): the fp32
    gradients of one tp 2 step @224 batch 16, gathered, against the
    single-card ``fused_train`` step's (1e-3 x max(1, max|g|) per leaf); the
    train CLI runs of ``TRAIN_RANK_RUNS`` with every rank's counts per step
    (tp: 12 K1, 12 K5 partial, 12 K6, 12 K8 ``residual=False``; no K2, K4 or
    K7), the dp 2 ``fused_adamw`` params equal bit for bit on both ranks;
    the tp step @512 batch 2 (12 K13, K14, K5 partial, K8 residual=False);
    the time per step of two ranks sharing one card.  -> (summary of K8
    residual=False, launch counts of rank 0 by path)."""
    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.models import vit

    cases, labels = k8_partial_cases(dev)
    summary = phase_kernels(cases, labels, TP_TRAIN_BATCH)
    del cases
    torch.cuda.empty_cache()

    _register_tp_config()
    cfg = get_config(RANK_CONFIG)
    _teacher_npz(workdir, cfg)
    _run_ranks("--rank-train-worker", workdir, TRAIN_RANKS_TIMEOUT, "training ranks")
    reports = [json.load(open(f"{workdir}/train_rank{r}.json")) for r in range(RANKS)]

    for r, rep in enumerate(reports):
        for path, (_, steps, per_step, tp) in TRAIN_RANK_RUNS.items():
            run = rep["runs"][path]
            if run["rc"] != 0:
                raise RuntimeError(f"rank {r} {path}: the train CLI exited {run['rc']}")
            _expect_cli(run["launches"], per_step, steps,
                        f"rank {r} {path} (B/16 widths depth {RANK_DEPTH}, {steps} steps)")
            _expect_flags(run["flags"], RANK_DEPTH * steps if tp else 0, f"rank {r} {path}")
            log(f"rank {r} {path}: per step {_per_step(run['launches'], steps)}")
        long = rep["runs"]["train_tp_long"]
        _expect_counts_of(long["launches"], TP_LONG_TRAIN_STEP,
                          f"rank {r} train_tp_long (@512 batch 2 bf16 tp 2, 1 step)")
        _expect_flags(long["flags"], RANK_DEPTH, f"rank {r} train_tp_long")
        if not np.isfinite(long["loss"]):
            raise RuntimeError(f"rank {r} train_tp_long: non-finite loss")
    for path in TRAIN_RANK_RUNS:
        log(f"{path} rank 0: " + " / ".join(reports[0]["runs"][path]["stdout"]))
    sha = [rep["runs"]["train_dp"]["params_sha256"] for rep in reports]
    log(f"train_dp (fused_adamw, 3 steps): params sha256 rank 0 {sha[0][:16]}, rank 1 "
        f"{sha[1][:16]}: {'equal' if sha[0] == sha[1] else 'DIFFERENT'}")
    if sha[0] != sha[1]:
        raise RuntimeError("dp 2: the params differ between the ranks after the steps")

    # the gathered tp 2 gradients against the single-card fused_train step's
    x, y = _tp_grad_batch(dev)
    tree = vit.init_params(torch.Generator().manual_seed(0), cfg)
    loss1, want = _grads(cfg, tree, x, y, "fused_train", None, dev)
    got = {k: torch.from_numpy(v).to(dev) for k, v in np.load(f"{workdir}/tp_grads.npz").items()}
    worst, worst_leaf = _worst_leaf(got, want)
    loss_tp = reports[0]["tp_grad_loss"]
    log(f"tp 2 fp32 grads (two ranks, gathered) vs single-card fused_train, B/16 widths depth "
        f"{RANK_DEPTH} batch "
        f"{TP_TRAIN_BATCH}: loss {loss_tp:.6g} vs {loss1:.6g}; {len(want)} leaves, worst "
        f"{worst_leaf} at {worst:.3g} of its bound (1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(got) != set(want) or not abs(loss_tp - loss1) <= 1e-3:
        raise RuntimeError("tp 2 gradients or loss outside 1e-3 of the single-card step's")

    for path in ("train_tp", "train_tp_fp32", "train_dp"):
        ms = [rec["ms"] for rec in reports[0]["runs"][path]["steps"][1:]]
        batch = TP_TRAIN_BATCH if path.startswith("train_tp") else DP_TRAIN_BATCH
        log(f"{path}: {statistics.median(ms):.6g} ms per step (median of steps 1-"
            f"{len(ms)}; {batch} images a step, {RANKS} ranks sharing one card over gloo: not a "
            f"scaling figure); {card}")
    launches = {path: reports[0]["runs"][path]["launches"]
                for path in (*TRAIN_RANK_RUNS, "train_tp_long")}
    return summary, launches


def _run_ranks(mode: str, workdir: str, timeout: int, what: str, ranks: int = RANKS) -> None:
    """``torchrun`` of ``ranks`` ranks of this script in ``mode`` (sharing
    the card over gloo), killed with its process group after ``timeout`` s."""
    import signal
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(ranks), os.path.abspath(__file__), mode, workdir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="4"))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and every rank it started
        proc.communicate()
        raise RuntimeError(f"{ranks} {what} did not finish in {timeout} s: a rank hung")
    lines = [ln for ln in out.splitlines() if "socket.cpp" not in ln]
    log("\n".join(f"{what}: {ln}" for ln in (lines if proc.returncode else lines[-8:])))
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun with {ranks} {what} exited {proc.returncode}")
    log(f"{ranks} {what} over gloo on one card: {time.perf_counter() - t0:.3f} s")


def _per_step(launches: dict, steps: int) -> dict:
    return {name: n / steps for name, n in launches.items() if n}


def _expect_flags(flags: dict, n: int, what: str) -> None:
    """Fail unless K5's partial form and K8's residual=False form ran ``n``
    times each (and the other forms of K5 and K8 none, on a tp run)."""
    partial, residual = flags["partial"], flags["residual"]
    off = residual[1] - residual[0]  # K8 launches with residual=False
    log(f"{what}: K5 partial {partial[0]} of {partial[1]}, K8 residual=False {off} of "
        f"{residual[1]}")
    if n and (partial != [n, n] or residual != [0, n]):
        raise RuntimeError(f"{what}: expected {n} K5 partial and {n} K8 residual=False launches "
                           f"and no other form, got K5 {partial}, K8 {residual}")
    if not n and (partial[0] or off):
        raise RuntimeError(f"{what}: a tensor-parallel form ran on a dp run")


def group_parallel(dev, card, summary, launches) -> None:
    """Phases 36-38 and 45."""
    from vit_tpu_torch.config import get_config
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
    _register_tp_config()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches.update(phase_parallel(synth_params(get_config(RANK_CONFIG), 0), dev, card,
                                       workdir))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        k8_summary, train_launches = phase_parallel_train(dev, card, workdir)
    summary.update(k8_summary)
    launches.update(train_launches)


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


# -- MAE pretraining, DeiT distillation and QAT (phases 42-44) -----------------

QAT_STEPS = 3


def _expect_cli(launches: dict, per_step: dict, steps: int, what: str) -> dict:
    """Fail unless the CLI run's counts are ``per_step`` x ``steps`` (the rest 0)."""
    return _expect_counts_of(launches, {name: n * steps for name, n in per_step.items()}, what)


def _mae_grads(cfg, mae_cfg, tree, x, noise, ops: str, compute_dtype, dev):
    """-> (loss, {leaf path: grad}) of one MAE backward on the masks of ``noise``."""
    from vit_tpu_torch.models import mae
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    params = trainer.as_trainable(tree, dev, torch.float32)
    p = params if compute_dtype is None else vit.cast_params(params, compute_dtype)
    loss = mae.forward_loss(p, x, None, cfg, mae_cfg, get_ops(ops), noise=noise)
    loss.backward()
    return loss.item(), {path: t.grad for path, t in _paths(params)}


def phase_mae_correctness(dev: torch.device) -> None:
    """Phase 42: the MAE loss and every leaf's gradient (encoder and
    decoder), fp32 fused_train against eager on the same masks, and the bf16
    mixed loss against fp32 (phase 9's rules)."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import mae

    cfg, mae_cfg = VIT_B_16, mae.MAEConfig()
    tree = mae.init_mae_params(torch.Generator().manual_seed(0), cfg, mae_cfg)
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    noise = torch.rand((4, cfg.num_patches), generator=torch.Generator(dev).manual_seed(1),
                       device=dev)
    lf, gf = _mae_grads(cfg, mae_cfg, tree, x, noise, "fused_train", None, dev)
    le, ge = _mae_grads(cfg, mae_cfg, tree, x, noise, "eager", None, dev)
    worst, worst_leaf = _worst_leaf(gf, ge)
    log(f"mae grads fp32 fused_train vs eager autograd (card, TF32 off), B/16 + decoder "
        f"{mae_cfg.decoder_dim}x{mae_cfg.decoder_depth} ({mae_cfg.decoder_heads} heads), 4 images, "
        f"the same masks: loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at "
        f"{worst:.3g} of its bound (1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(gf) != set(ge) or not abs(lf - le) <= 1e-3 * max(1.0, abs(le)):
        raise RuntimeError("MAE fused_train loss or gradients outside 1e-3 of eager autograd")
    del gf, ge
    lb, _ = _mae_grads(cfg, mae_cfg, tree, x, noise, "fused_train", torch.bfloat16, dev)
    log(f"mae loss bf16 mixed vs fp32 fused_train: {lb:.6g} vs {lf:.6g}, |d|={abs(lb - lf):.6g} "
        f"(tol 2e-2)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("MAE bf16 mixed-precision loss outside 2e-2 of fp32")


def phase_mae_cli(workdir: str) -> tuple:
    """Phase 42: the train CLI with ``--mae --save-backbone`` (20 each of
    K1, K4, K5, K6, K7 per step: 12 encoder and 8 decoder blocks; no K2 or
    K3), then ``--init-weights`` of the saved backbone (12 each a step).
    -> launch counts of the two runs."""
    backbone = f"{workdir}/backbone.npz"
    path = ("ln_qkv_attn", *TRAIN_KERNELS)
    launches, losses = _train_cli(workdir, ["--mae", "--save-backbone", backbone])
    _expect_cli(launches, {name: 20 for name in path}, TRAIN_STEPS, "train cli --mae")
    log(f"mae pretraining losses {losses}")
    tuned, _ = _train_cli(workdir, ["--init-weights", backbone], steps=2)
    _expect_cli(tuned, {name: 12 for name in path}, 2, "train cli --init-weights backbone")
    return launches, tuned


def phase_mae_throughput(dev: torch.device, card: str) -> None:
    """Phase 42: MAE step img/s at batch 64 bf16 mixed, fused_train and
    eager, beside the supervised fused_train step, timed in turns, with the
    peak memory of each; then one MAE fused_train step in a profiler trace."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import mae, vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg, mae_cfg, b = VIT_B_16, mae.MAEConfig(), 64
    x = torch.from_numpy(synth_images(b, cfg, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % cfg.num_classes

    def mae_step(ops):
        params = trainer.as_trainable(
            mae.init_mae_params(torch.Generator().manual_seed(0), cfg, mae_cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_mae_train_step(cfg, mae_cfg, opt, torch.Generator(dev).manual_seed(0),
                                           get_ops(ops), compute_dtype=torch.bfloat16)
        return lambda: float(step(params, x, None))

    def supervised():
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                       compute_dtype=torch.bfloat16)
        return lambda: float(step(params, x, y))

    _step_rates({"mae fused_train": lambda: mae_step("fused_train"),
                 "mae eager": lambda: mae_step("eager"), "supervised fused_train": supervised},
                b, "mae train throughput", cfg.name, card)
    torch.cuda.empty_cache()
    _profile_call(mae_step("fused_train"), f"mae fused_train {cfg.name} batch {b} bf16 mixed",
                  "step", card)


def _teacher_npz(workdir: str, cfg=None) -> str:
    """The teacher of phase 43: ``vit_b_16`` (or ``cfg``) from
    ``init_params`` seed 1, as an .npz."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import vit

    path = f"{workdir}/teacher.npz"
    ckpt.save_npz(params_to_numpy(vit.init_params(torch.Generator().manual_seed(1),
                                                  cfg or VIT_B_16)), path)
    return path


def phase_distill_correctness(dev: torch.device) -> None:
    """Phase 43: the distillation step's loss and every leaf's gradient
    (both heads included), fp32 fused_train against eager, hard and soft,
    on one set of teacher logits (a moved argmax would otherwise change the
    targets); the fused teacher's fp32 logits against the eager teacher's."""
    from vit_tpu_torch.config import DEIT_B_16, VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    x = torch.from_numpy(synth_images(4, DEIT_B_16, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    teacher = params_from_numpy(synth_params(VIT_B_16, 1), dev)
    with torch.no_grad():
        t_fused = vit.forward(teacher, x, VIT_B_16, get_ops("fused"))
        t_eager = vit.forward(teacher, x, VIT_B_16)
    d = (t_fused - t_eager).abs().max().item()
    log(f"distill teacher fp32 fused vs eager (card, TF32 off), 4 images: max|d logit|={d:.6g} "
        f"(tol 1e-3)")
    if not d <= 1e-3:
        raise RuntimeError("the fused teacher's logits are outside 1e-3 of the eager teacher's")
    tree = params_from_numpy(synth_params(DEIT_B_16, 0), "cpu")
    for hard in (True, False):
        got = {}
        for ops in ("fused_train", "eager"):
            params = trainer.as_trainable(tree, dev, torch.float32)
            step = trainer.make_distill_train_step(
                DEIT_B_16, torch.optim.SGD(list(trainer.leaves(params)), lr=0.0),
                lambda images: t_fused, get_ops(ops), remat=False, hard=hard, tau=2.0)
            loss = float(step(params, x, y))  # lr 0: the gradients stay in .grad
            got[ops] = loss, {path: t.grad for path, t in _paths(params)}
            del params, step
        (lf, gf), (le, ge) = got["fused_train"], got["eager"]
        worst, worst_leaf = _worst_leaf(gf, ge)
        mode = "hard" if hard else "soft (tau 2)"
        log(f"distill {mode} grads fp32 fused_train vs eager autograd, deit_b_16, 4 images: loss "
            f"{lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at {worst:.3g} of its "
            f"bound (1e-3 x max(1, max|g|)); head_dist max|g| "
            f"{ge['head_dist/kernel'].abs().max().item():.6g}")
        if (worst > 1.0 or set(gf) != set(ge) or not abs(lf - le) <= 1e-3 * max(1.0, abs(le))
                or not ge["head_dist/kernel"].abs().max().item() > 0):
            raise RuntimeError(f"distill {mode}: fused_train outside 1e-3 of eager autograd")
        del got, gf, ge


def phase_distill_cli(workdir: str, teacher: str) -> tuple:
    """Phase 43: the train CLI on ``deit_b_16`` with ``--distill-teacher``
    (the student's 12 each of K1, K4-K7 and the fused teacher's 12 K1, 12
    K2 and 1 K3 a step), then with ``--distill-teacher-int8`` (the teacher's
    12 K15, 12 K16 and 1 K3 a step).  -> launch counts of the two runs."""
    student = {name: 12 for name in ("ln_qkv_attn", *TRAIN_KERNELS)}
    base = ["--config", "deit_b_16", "--distill-teacher", teacher]
    fused, _ = _train_cli(workdir, base)
    _expect_cli(fused, {**student, "ln_qkv_attn": 24, "out_ln_mlp_residual": 12,
                        "layer_norm": 1}, TRAIN_STEPS, "train cli --distill-teacher")
    int8, _ = _train_cli(workdir, [*base, "--distill-teacher-int8"])
    _expect_cli(int8, {**student, "ln_qkv_attn_q8": 12, "out_ln_mlp_residual_q8": 12,
                       "layer_norm": 1}, TRAIN_STEPS, "train cli --distill-teacher-int8")
    return fused, int8


def phase_distill_throughput(dev: torch.device, card: str, teacher: str) -> None:
    """Phase 43: the distillation step's img/s at batch 64 bf16 mixed with
    the fused and the int8 teacher, beside the plain deit_b_16 step, timed
    in turns, with the peak memory of each."""
    from vit_tpu_torch.cli.train_args import build_parser
    from vit_tpu_torch.cli.train_setup import _teacher
    from vit_tpu_torch.config import DEIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg, b = DEIT_B_16, 64
    x = torch.from_numpy(synth_images(b, cfg, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % cfg.num_classes

    def run(int8=None):
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        if int8 is None:
            step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                           compute_dtype=torch.bfloat16)
        else:
            args = build_parser().parse_args(
                ["--config", cfg.name, "--distill-teacher", teacher, "--mixed-precision",
                 *(["--distill-teacher-int8"] if int8 else [])])
            with contextlib.redirect_stdout(io.StringIO()):
                t_fwd = _teacher(args, cfg, "fused_train", dev, torch.bfloat16)
            step = trainer.make_distill_train_step(cfg, opt, t_fwd, get_ops("fused_train"),
                                                   remat=False, compute_dtype=torch.bfloat16)
        return lambda: float(step(params, x, y))

    _step_rates({"distill fused teacher": lambda: run(False),
                 "distill int8 teacher": lambda: run(True), "plain": run},
                b, "distill train throughput", cfg.name, card)


def phase_qat(params, dev: torch.device, card: str, workdir: str) -> dict:
    """Phase 44: the train CLI with ``--ops qat`` (no kernel launches, a
    loss that falls), QAT then deploy (the fp32 ``qat`` forward against the
    fp32 ``quant`` kernels' on the same weights at batch 100, by the
    comparator rule), and the QAT step's img/s beside the eager step's.
    -> launch counts of the CLI run and of the deployed forward."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    launches, losses = _train_cli(workdir, ["--ops", "qat", "--lr", str(TRAIN_LR)],
                                  steps=QAT_STEPS)
    _expect_counts_of(launches, {}, "train cli --ops qat")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"QAT train CLI: the loss did not fall ({losses})")
    log(f"qat train losses {losses}")
    images = synth_images(100, VIT_B_16, seed=1)
    qat = InferenceEngine(VIT_B_16, params, "float32", "qat", dev, batch_pad=1)
    wrappers = _reset_counts()
    pq = _probs(qat.logits(images).cpu().numpy())
    _expect_counts(wrappers, {}, "qat forward")
    del qat
    quant = InferenceEngine(VIT_B_16, params, "float32", "quant", dev, batch_pad=1)
    wrappers = _reset_counts()
    p8 = _probs(quant.logits(images).cpu().numpy())
    deployed = _expect_counts(wrappers, {"ln_qkv_attn_q8": 12, "out_ln_mlp_residual_q8": 12,
                                         "layer_norm": 1}, "deployed quant forward")
    del quant
    _comparator_rule("qat then deploy: fp32 quant kernels vs fp32 qat forward", p8, pq)
    torch.cuda.empty_cache()
    _train_rates(dev, card, {"qat": ("qat", False), "eager": ("eager", False)},
                 "qat train throughput")
    return launches, deployed


def group_mae(dev, card, summary, launches) -> None:
    """Phase 42."""
    from vit_tpu_torch.ops.kernels import _build

    phase_mae_correctness(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_mae"], launches["train_mae_finetune"] = phase_mae_cli(workdir)
    torch.cuda.empty_cache()
    phase_mae_throughput(dev, card)


def group_distill(dev, card, summary, launches) -> None:
    """Phase 43."""
    from vit_tpu_torch.ops.kernels import _build

    phase_distill_correctness(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        teacher = _teacher_npz(workdir)
        launches["train_distill"], launches["train_distill_int8"] = phase_distill_cli(
            workdir, teacher)
        torch.cuda.empty_cache()
        phase_distill_throughput(dev, card, teacher)


def group_qat(dev, card, summary, launches) -> None:
    """Phase 44."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_qat"], launches["qat_deploy_quant"] = phase_qat(
            synth_params(VIT_B_16, 0), dev, card, workdir)


# -- data and evaluation (phase 46) ----------------------------------------------

DATA_SHARDS = (86, 85, 85)  # phase 46's B/16 @224 images per shard: 256, ~154 MB
DATA_BATCH = 100  # the eval CLI's batch: 100, 100 and a ragged 56
DATA_STEPS = 3  # the --data-dir train CLI's steps (batch 64)
FOLDER_CLASSES, FOLDER_PER_CLASS, FOLDER_WH = 4, 8, (256, 320)  # PNG width x height
EVAL_RUNS = {  # name: (eval CLI flags, launches per batch)
    "eval_fused": (["--ops", "fused"], {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12,
                                        "layer_norm": 1}),
    "eval_quant": (["--ops", "quant"], {"ln_qkv_attn_q8": 12, "out_ln_mlp_residual_q8": 12,
                                        "layer_norm": 1}),
    "eval_tome": (["--ops", "fused", "--tome", str(TOME_R)],
                  {"ln_qkv_attn": 12, "out_residual": 12, "ln_mlp_residual": 12}),
}


def _write_shards(root: str, images: np.ndarray, labels: np.ndarray) -> None:
    """``images`` as input-100.bin-format shards of DATA_SHARDS images, each
    with its int32 ``.labels.bin``."""
    lo = 0
    for i, n in enumerate(DATA_SHARDS):
        with open(f"{root}/shard{i}.bin", "wb") as fh:
            np.array((n, *images.shape[1:]), "<i4").tofile(fh)
            images[lo : lo + n].astype("<f4").tofile(fh)
        labels[lo : lo + n].astype("<i4").tofile(f"{root}/shard{i}.labels.bin")
        lo += n


def _engine_reference(cfg, params, images, labels, dev, ops: str, tome_r: int = 0) -> tuple:
    """(top-1, top-5, ties) of ``labels`` from a bf16 engine's own forward
    over the eval CLI's batches (DATA_BATCH, batch_pad DATA_BATCH): its
    ``classify`` labels, ranked as ``eval/accuracy.py`` ranks the float32
    probabilities (``np.argsort``'s last of the five largest).  Where the
    two top-1s differ the probabilities must tie (bf16 logits often do on
    random weights); ``ties`` counts those images."""
    from vit_tpu_torch.runtime.engine import InferenceEngine

    bs = min(DATA_BATCH, len(images))
    engine = InferenceEngine(cfg, params, "bfloat16", ops, dev, batch_pad=bs, tome_r=tome_r)
    hits1 = hits5 = ties = 0
    for i in range(0, len(images), bs):
        x, y = images[i : i + bs], labels[i : i + bs]
        top1, top_prob = engine.classify(x)
        probs = engine.probabilities(x).cpu().numpy().astype(np.float32)
        top5 = np.argsort(probs, axis=-1)[:, -5:]
        rows = np.arange(len(y))
        if not np.array_equal(probs[rows, top5[:, -1]], top_prob):
            raise RuntimeError(f"{ops}: classify's top probability is not the ranked top-1's")
        ties += int((top5[:, -1] != top1).sum())
        hits1 += int((top5[:, -1] == y).sum())
        hits5 += int((top5 == y[:, None]).any(-1).sum())
    return hits1 / len(images), hits5 / len(images), ties


def phase_data_reader(workdir: str, params, dev, card: str) -> tuple:
    """Phase 46 (the reader): the native reader built from
    ``native/vitio.cpp``; 256 B/16 @224 images in 3 shards, labelled with the
    fp32 ``eager`` engine's top-1; native reads against numpy's bit for bit.
    -> (images, labels)."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import native
    from vit_tpu_torch.io.dataset import BinShardDataset
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    t0 = time.perf_counter()
    if not native.gather_available():
        raise RuntimeError("the native reader did not build (no C++ compiler?)")
    log(f"native reader: {native.library_path().name}, {time.perf_counter() - t0:.3f} s "
        "(build and load)")
    images = synth_images(sum(DATA_SHARDS), VIT_B_16, seed=5)
    eager = InferenceEngine(VIT_B_16, params, "float32", "eager", dev, batch_pad=DATA_BATCH)
    labels = np.concatenate([eager.classify(images[i : i + DATA_BATCH])[0]
                             for i in range(0, len(images), DATA_BATCH)]).astype(np.int32)
    del eager
    _write_shards(workdir, images, labels)
    ds = BinShardDataset(workdir, require_labels=True, num_classes=VIT_B_16.num_classes)
    take = np.random.default_rng(0).permutation(len(ds))
    reads, secs = {}, {"native": [], "numpy": []}
    for _ in range(2):  # in turns
        for reader in ("native", "numpy", "numpy", "native"):
            with unittest.mock.patch.object(native, "gather_available",
                                            lambda: reader == "native"):
                t0 = time.perf_counter()
                reads[reader] = ds.read(take)
                secs[reader].append(time.perf_counter() - t0)
    if not (reads["native"].tobytes() == reads["numpy"].tobytes() == images[take].tobytes()
            and np.array_equal(ds.labels(), labels)):
        raise RuntimeError("native shard reads differ from numpy's")
    mb = images.nbytes / 1e6
    rate = {k: mb / statistics.median(v) for k, v in secs.items()}
    log(f"data: {len(ds)} images in {len(ds.paths)} shards ({mb:.1f} MB), the native gather "
        f"reader's reads == numpy memmap reads == the written images bit for bit; a shuffled "
        f"BinShardDataset.read of all (median of 4, in turns, host, page cache warm): native "
        f"{rate['native']:.6g} MB/s, numpy {rate['numpy']:.6g} MB/s; labels: the fp32 eager "
        f"top-1")
    return images, labels


def phase_eval_cli(workdir: str, params, images, labels, dev, card: str) -> dict:
    """Phase 46 (evaluation): ``vit-tpu-torch-eval --data-dir`` bf16 at
    batch DATA_BATCH on ``fused``, ``quant`` and ToMe r = TOME_R, counts set
    to 0 just before and read just after; each run's top-1 and top-5 equal
    those of the same engine's ``classify``; then ``--image-dir``.
    -> launch counts by path."""
    from vit_tpu_torch.cli.eval import main
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.dataset import ImageFolderDataset

    weights = f"{workdir}/params.npz"
    checkpoint.save_npz(params, weights)
    batches = -(-len(images) // DATA_BATCH)

    def run(flags, per_batch, n_batches, imgs, labs, source):
        buf = io.StringIO()
        wrappers = _reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = main(["--weights", weights, *source, "--batch", str(DATA_BATCH), "--dtype",
                       "bfloat16", "--device", "cuda", "--json", *flags])
        launches = {k: fn.launches for k, fn in wrappers.items()}
        if rc != 0:
            raise RuntimeError(f"eval CLI {flags} exited {rc}")
        got = json.loads(buf.getvalue().splitlines()[-1])
        _expect_counts_of(launches, {k: n * n_batches for k, n in per_batch.items()},
                          f"eval cli {' '.join(flags)} ({n_batches} batches)")
        tome = int(flags[flags.index("--tome") + 1]) if "--tome" in flags else 0
        *want, ties = _engine_reference(VIT_B_16, params, imgs, labs, dev, flags[1], tome)
        log(f"eval cli {' '.join(source[:1] + flags)}: {got['n']} images, top-1 {got['top1']} "
            f"top-5 {got['top5']} mean top-prob {got['mean_top_prob']:.6g}; the engine's "
            f"classify: top-1 {want[0]} top-5 {want[1]} ({ties} top-1 ties ranked as numpy "
            f"ranks them); {got['images_per_sec']} img/s (shard reads and the first forward "
            f"included); {card}")
        if got["n"] != len(imgs) or [got["top1"], got["top5"]] != want:
            raise RuntimeError(f"eval CLI {flags}: {got} != the engine's {want}")
        return launches

    out = {name: run(flags, per_batch, batches, images, labels, ["--data-dir", workdir])
           for name, (flags, per_batch) in EVAL_RUNS.items()}
    from PIL import Image

    rng = np.random.default_rng(3)
    folder = f"{workdir}/classes"
    for c in range(FOLDER_CLASSES):
        os.makedirs(f"{folder}/c{c}")
        for j in range(FOLDER_PER_CLASS):
            Image.fromarray(rng.integers(0, 256, (FOLDER_WH[1], FOLDER_WH[0], 3),
                                         dtype=np.uint8)).save(f"{folder}/c{c}/{j}.png")
    ds = ImageFolderDataset(folder, VIT_B_16.image_size)
    flags, per_batch = EVAL_RUNS["eval_fused"]
    out["eval_image_dir"] = run(flags, per_batch, 1, ds.read(range(len(ds))),
                                ds.labels(), ["--image-dir", folder])
    return out


def phase_eval_stream(workdir: str, params, dev, card: str) -> None:
    """Phase 46 (the prefetch): ``evaluate_batches`` over the shards streamed
    through ``prefetch_to_device`` against the same batches already on the
    card, bf16 ``fused``, timed in turns."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.eval import accuracy
    from vit_tpu_torch.io.dataset import BinShardDataset
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.prefetch import prefetch_to_device

    ds = BinShardDataset(workdir, require_labels=True)
    engine = InferenceEngine(VIT_B_16, params, "bfloat16", "fused", dev, batch_pad=DATA_BATCH)
    spans = [range(i, min(i + DATA_BATCH, len(ds))) for i in range(0, len(ds), DATA_BATCH)]
    staged = [(torch.from_numpy(ds.read(r)).to(dev), ds.labels()[r.start : r.stop]) for r in spans]

    def streamed():
        stream = prefetch_to_device(((ds.read(r), ds.labels()[r.start : r.stop]) for r in spans),
                                    size=2, device=dev)
        try:
            return accuracy.evaluate_batches(engine, stream)
        finally:
            stream.close()

    runs = {"streamed": streamed, "staged": lambda: accuracy.evaluate_batches(engine, staged)}
    reports = {k: fn() for k, fn in runs.items()}  # warm
    if reports["streamed"] != reports["staged"]:
        raise RuntimeError(f"streamed eval {reports['streamed']} != staged {reports['staged']}")
    times = {k: [] for k in runs}
    for _ in range(3):
        for k in (*runs, *reversed(runs)):
            t0 = time.perf_counter()
            runs[k]()
            times[k].append(time.perf_counter() - t0)
    rates = {k: len(ds) / statistics.median(t) for k, t in times.items()}
    log(f"eval stream B/16 bf16 fused, {len(ds)} images in batches of {DATA_BATCH}: prefetched "
        f"from the shards {rates['streamed']:.6g} img/s, already on the card "
        f"{rates['staged']:.6g} img/s (median of 6 each, in turns); {card}")


def phase_data_train_cli(workdir: str, card: str) -> dict:
    """Phase 46 (training): the train CLI with ``--data-dir`` (B/16 b64
    ``fused_train``, ``--optimizer fused_adamw``, DATA_STEPS steps) and
    ``--eval-data-dir --eval-every 2 --eval-batches 1``: 12 each of K1,
    K4-K7 and 1 K20 per step (the held-out eval is the fp32 eager forward:
    no launch); its step times beside the static-batch CLI's.
    -> launch counts of the run."""
    base = ["--optimizer", "fused_adamw", "--lr", str(TRAIN_LR)]
    records: list = []
    launches, losses = _train_cli(workdir, [*base, "--data-dir", workdir, "--data-threads", "8",
                                            "--eval-data-dir", workdir, "--eval-every", "2",
                                            "--eval-batches", "1"], DATA_STEPS, records)
    want = {name: 12 * DATA_STEPS for name in ("ln_qkv_attn", *TRAIN_KERNELS)}
    want["adamw_update"] = DATA_STEPS
    _expect_counts_of(launches, want, f"train cli --data-dir ({DATA_STEPS} steps)")
    evals = [r for r in records if "eval_top1" in r]
    if [r["step"] for r in evals] != [1, DATA_STEPS] or not evals[-1].get("final"):
        raise RuntimeError(f"train cli --eval-data-dir: eval records {evals}")
    static: list = []
    _train_cli(workdir, base, DATA_STEPS, static)
    ms = {what: [r["ms"] for r in recs if "ms" in r]
          for what, recs in (("data-dir", records), ("static", static))}
    log(f"train cli B/16 batch 64 fused_train fused_adamw, step ms (the first includes its "
        f"warm-up): --data-dir {ms['data-dir']}, static batch {ms['static']}; losses {losses}; "
        f"eval top-1 {[r['eval_top1'] for r in evals]} (64 held-out images); {card}")
    return launches


def phase_oracle_and_timing(params, dev, card: str) -> None:
    """Phase 46 (the gate and the recipes): the oracle's float64 logits on 4
    images against fp32 ``eager`` and ``fused`` on the card (1e-3, BASELINE's
    gate); ``roofline`` and ``forward_timing`` of the b100 bf16 ``fused``
    forward, ``train_step_timing`` of the b64 bf16 mixed ``fused_train``
    step."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import oracle, vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import profiler, trainer
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    images = synth_images(100, cfg, seed=1)
    t0 = time.perf_counter()
    want = oracle.forward(params, images[:4], cfg)
    t_oracle = time.perf_counter() - t0
    devs = {}
    for ops in ("eager", "fused"):
        engine = InferenceEngine(cfg, params, "float32", ops, dev, batch_pad=1)
        devs[ops] = float(np.abs(engine.logits(images[:4]).cpu().numpy() - want).max())
        del engine
    log(f"oracle (float64, CPU, {t_oracle:.3g} s) vs fp32 on the card, 4 images, TF32 off: max|d "
        f"logit| eager {devs['eager']:.6g}, fused {devs['fused']:.6g} (gate 1e-3)")
    if not max(devs.values()) <= 1e-3:
        raise RuntimeError(f"fp32 logits outside 1e-3 of the oracle: {devs}")

    engine = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=100)
    x = torch.from_numpy(images).to(dev)
    med, lo, hi = profiler.forward_timing(lambda: engine.logits(x), iters=10)
    r = profiler.roofline(cfg, 100, med)
    log(f"forward_timing fused B/16 batch 100 bf16: {med * 1e3:.6g} ms (min {lo * 1e3:.6g}, max "
        f"{hi * 1e3:.6g}; 3 samples of 10); roofline {r['tflops_per_sec']:.6g} TFLOP/s, mfu "
        f"{r['mfu']:.4%} of h100_bf16, {r['images_per_sec']:.6g} img/s; {card}")
    del engine, x
    torch.cuda.empty_cache()
    params_t = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
    opt = torch.optim.AdamW(list(trainer.leaves(params_t)), lr=1e-4)
    step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                   compute_dtype=torch.bfloat16)
    xb = torch.from_numpy(synth_images(64, cfg, seed=4)).to(dev)
    yb = torch.arange(64, device=dev) * 7 % cfg.num_classes
    med, lo, hi, loss = profiler.train_step_timing(step, params_t, xb, yb, iters=5)
    log(f"train_step_timing fused_train B/16 batch 64 bf16 mixed, AdamW: {med * 1e3:.6g} ms "
        f"(min {lo * 1e3:.6g}, max {hi * 1e3:.6g}; 3 samples of 5), {64 / med:.6g} img/s, "
        f"last loss {loss:.6g}; {card}")


def group_data(dev, card, summary, launches) -> None:
    """Phase 46."""
    from vit_tpu_torch.config import VIT_B_16

    params = synth_params(VIT_B_16, 0)
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        images, labels = phase_data_reader(workdir, params, dev, card)
        torch.cuda.empty_cache()
        launches.update(phase_eval_cli(workdir, params, images, labels, dev, card))
        del images
        torch.cuda.empty_cache()
        phase_eval_stream(workdir, params, dev, card)
        torch.cuda.empty_cache()
        launches["train_data"] = phase_data_train_cli(workdir, card)
    torch.cuda.empty_cache()
    phase_oracle_and_timing(params, dev, card)


# -- the training loop's state and recipe (phase 47) --------------------------------

RECIPE_STEPS = 4  # the straight run's steps; the preempted run stops at 2
RECIPE_EMA_DECAY = 0.999
RECIPE_FLAGS = ["--optimizer", "fused_adamw", "--lr", str(TRAIN_LR), "--augment",
                "crop,flip,mixup,cutmix", "--ema-decay", str(RECIPE_EMA_DECAY), "--eval-every", "2",
                "--eval-batches", "1", "--data-threads", "8"]
RECIPE_STEP = {"ln_qkv_attn": 12, **{name: 12 for name in TRAIN_KERNELS}, "adamw_update": 1}
RECIPE_TP_DEPTH = 2  # the tp 2 save and resume's depth (B/16 widths)
RECIPE_TP_CONFIG = "vit_b_16_depth2"
RECIPE_TP_FLAGS = ["--config", RECIPE_TP_CONFIG, "--batch", str(TP_TRAIN_BATCH), "--ops",
                   "fused_train", "--lr", str(TRAIN_LR), "--ema-decay", str(RECIPE_EMA_DECAY),
                   "--seed", "3"]
RECIPE_RANKS_TIMEOUT = 240  # s: a rank that hangs fails phase 47
# The tp 2 archives against the one-card ones (fp32, TF32 off: their
# gradients differ by the order of the tp sums alone).  Adam moves a param
# by about lr a step whatever its gradient's size (the first step by
# lr * sign(g)), so the few elements of a weight whose gradient is as small
# as its rounding move +-lr by a coin: a param or EMA leaf is held by the L2
# norm of its difference, within RECIPE_TP_TOL of the L2 norm of its move
# from the run's start.  The key bias's gradient is zero in exact
# arithmetic (softmax is blind to a constant added to every key), so it is
# rounding alone and its sign is a coin: its columns are held to the Adam
# bound, lr a step (in the EMA, 1 - decay of the params' gap summed over
# the steps: at most (1 - decay) steps^2 lr).  Moments within
# RECIPE_MOMENT_TOL of each leaf's largest magnitude.  One step on another
# batch must break the params', the moments' and the EMA's bounds: a
# planted run shows it.
RECIPE_TP_TOL = 1e-2
RECIPE_MOMENT_TOL = 1e-3


def _register_tp_config() -> None:
    """``vit_b_16_depth2`` (and the DeiT student ``deit_b_16_depth2``): B/16
    widths at depth 2, for the rank runs of phases 38, 45, 47 and 49."""
    from vit_tpu_torch.config import CONFIGS, DEIT_B_16, VIT_B_16

    CONFIGS[RECIPE_TP_CONFIG] = dataclasses.replace(VIT_B_16, depth=RECIPE_TP_DEPTH,
                                                    name=RECIPE_TP_CONFIG)
    CONFIGS[RANK_DEIT_CONFIG] = dataclasses.replace(DEIT_B_16, depth=RANK_DEPTH,
                                                    name=RANK_DEIT_CONFIG)


@contextlib.contextmanager
def _patched_steps(sigterm_in: int = -1, shift: int = 0):
    """The train CLI's steps send this process SIGTERM in step
    ``sigterm_in`` (the loop's handler finishes the step, checkpoints and
    exits), and draw their randomness as step ``step - shift`` (``shift``
    > 0 plants a resume whose draws restart at step 0)."""
    import signal

    from vit_tpu_torch.runtime import trainer

    orig = trainer.make_train_step_dp

    def make(*args, **kwargs):
        inner = orig(*args, **kwargs)

        def step(params, x, y, step=None):
            if step == sigterm_in:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(params, x, y, step=step - shift)

        return step

    with unittest.mock.patch.object(trainer, "make_train_step_dp", make):
        yield


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _differing_leaves(got: dict, want: dict) -> list:
    """The keys of two archives (train states or params trees) whose leaves
    are not bit for bit equal: the key, dtype, shape and every value."""
    if sorted(got) != sorted(want):
        return sorted(set(got) ^ set(want))
    return [k for k, w in want.items()
            if got[k].dtype != w.dtype or not np.array_equal(got[k], w)]


def _expect_identical(got: dict, want: dict, what: str) -> None:
    differ = _differing_leaves(got, want)
    if differ:
        raise RuntimeError(f"{what}: {len(differ)} of {len(want)} leaves not bit for bit "
                           f"equal: {differ[:6]}")


def _key_bias_columns(cfg) -> np.ndarray:
    """bqkv's key columns in the packed (head, {q,k,v}, head_dim) order."""
    dh = cfg.embed_dim // cfg.num_heads
    return np.concatenate([np.arange(h * 3 * dh + dh, h * 3 * dh + 2 * dh)
                           for h in range(cfg.num_heads)])


def _tp_mismatches(got: dict, want: dict, start: dict, cfg, steps: int) -> tuple:
    """A tp archive ``got`` (a train state or an EMA tree) against the
    one-card ``want`` of the same step, both run on from ``start`` (its
    archive of the same kind) for ``steps`` steps, under the bounds above
    (a moment's and the key bias's on the largest difference, a param's and
    an EMA leaf's on the L2 norm).
    -> (the leaves out of bounds, {class: (worst ratio to its bound, key)})."""
    if sorted(got) != sorted(want):
        return [f"keys {sorted(set(got) ^ set(want))}"], {}
    state = "__step__" in want
    cols = _key_bias_columns(cfg)
    bad, worst = [], {}

    def hold(key, cls, g, w, bound, norm=False):
        diff = g.astype(np.float64) - w
        d = float(np.linalg.norm(diff) if norm else np.abs(diff).max()) if g.size else 0.0
        ratio = d / bound if bound > 0 else (0.0 if d == 0 else math.inf)
        if ratio > worst.get(cls, (-1.0,))[0]:
            worst[cls] = (ratio, key)
        if not ratio <= 1.0:
            bad.append(f"{key} ({cls}) {d:.6g} > {bound:.6g}")

    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            bad.append(f"{k} {g.dtype}{g.shape} != {w.dtype}{w.shape}")
        elif w.dtype.kind in "bi":
            if not np.array_equal(g, w):
                bad.append(f"{k} {g} != {w}")
        elif k.startswith("opt."):  # a moment (the key bias's: rounding, far inside)
            hold(k, "moments", g, w, RECIPE_MOMENT_TOL * float(np.abs(w).max()))
        else:
            cls = "params" if state else "ema"
            s = start[k]
            if k.endswith("blocks/bqkv"):
                adam = steps * TRAIN_LR if state else (1 - RECIPE_EMA_DECAY) * steps ** 2 * TRAIN_LR
                hold(k, f"{cls} key bias", g[:, cols], w[:, cols],
                     adam + 2 * float(np.spacing(np.abs(w[:, cols]).max())))
                g, w, s = (np.delete(a, cols, axis=1) for a in (g, w, s))
            hold(k, cls, g, w, RECIPE_TP_TOL * float(np.linalg.norm(w.astype(np.float64) - s)),
                 norm=True)
    return bad, worst


def _worst_text(worst: dict) -> str:
    return ", ".join(f"{cls} {r:.3g} ({k})" for cls, (r, k) in sorted(worst.items()))


def phase_recipe_resume(workdir: str, card: str) -> dict:
    """Phase 47 (resume): the recipe's train CLI 4 steps straight with
    ``--save-state --save-every 2``; the same run sent SIGTERM in its
    second step (rc 0, checkpointed at step 2); that archive resumed for 2
    steps; the straight and resumed archives and EMA sidecars equal leaf
    for leaf, bit for bit.  Two planted faults must break that equality: a
    resume whose draws restart at step 0, and a resume without the EMA
    sidecar.  -> launch counts by path."""
    import shutil

    from vit_tpu_torch.cli.train_loop import ema_sidecar
    from vit_tpu_torch.io import checkpoint

    base = [*RECIPE_FLAGS, "--data-dir", workdir, "--eval-data-dir", workdir]
    straight, first, resumed = (f"{workdir}/{n}.npz" for n in ("straight", "first", "resumed"))
    records: list = []
    out = {}
    out["train_recipe"], losses = _train_cli(
        workdir, [*base, "--save-state", straight, "--save-every", "2"], RECIPE_STEPS, records)
    _expect_counts_of(out["train_recipe"], {k: n * RECIPE_STEPS for k, n in RECIPE_STEP.items()},
                      f"train cli recipe ({RECIPE_STEPS} steps)")
    evals = [r for r in records if "eval_top1" in r]
    if [r["step"] for r in evals] != [1, 3]:
        raise RuntimeError(f"train cli recipe: eval records {evals}")
    with _patched_steps(sigterm_in=1):
        preempted, first_losses = _train_cli(workdir, [*base, "--save-state", first],
                                             RECIPE_STEPS, logged=2)
    _expect_counts_of(preempted, {k: n * 2 for k, n in RECIPE_STEP.items()},
                      "train cli recipe, SIGTERM in step 2")
    if checkpoint.peek_step(first) != 2:
        raise RuntimeError(f"SIGTERM: the archive is at step {checkpoint.peek_step(first)}, not 2")
    out["train_recipe_resumed"], resumed_losses = _train_cli(
        workdir, [*base, "--resume", first, "--save-state", resumed], 2)
    _expect_counts_of(out["train_recipe_resumed"], {k: n * 2 for k, n in RECIPE_STEP.items()},
                      "train cli recipe resumed (2 steps)")
    want, want_ema = _archive(straight), _archive(ema_sidecar(straight))
    _expect_identical(_archive(resumed), want, "resumed vs straight")
    _expect_identical(_archive(ema_sidecar(resumed)), want_ema, "resumed EMA vs straight EMA")
    # the planted faults: each must make the check fail
    redrawn, bare, bare_out = (f"{workdir}/{n}.npz" for n in ("redrawn", "bare", "bare_out"))
    with _patched_steps(shift=2):
        _train_cli(workdir, [*base, "--resume", first, "--save-state", redrawn], 2)
    shutil.copy(first, bare)  # the archive without its EMA sidecar
    _train_cli(workdir, [*base, "--resume", bare, "--save-state", bare_out], 2)
    planted = {
        "draws restarted at step 0": _differing_leaves(_archive(redrawn), want),
        "EMA sidecar dropped (its EMA)": _differing_leaves(_archive(ema_sidecar(bare_out)),
                                                           want_ema),
    }
    caught = {name: len(d) for name, d in planted.items()}
    if not all(caught.values()):
        raise RuntimeError(f"the resume check cannot see a planted fault: leaves differing "
                           f"{caught}")
    log(f"recipe resume (B/16 b64 bf16 fused_train fused_adamw, augment crop,flip,mixup,cutmix, "
        f"EMA 0.999, --data-dir): straight losses {losses}, step ms (the first includes its "
        f"warm-up) {[r['ms'] for r in records if 'ms' in r]}; SIGTERM in step 2 -> checkpointed "
        f"at step 2, rc 0; resumed {resumed_losses}; step-4 archive resumed vs straight: every "
        f"one of {len(want)} leaves bit for bit, EMA sidecar every one of {len(want_ema)}; "
        f"planted faults caught (leaves that differ): {caught}; eval top-1 (ema) "
        f"{[r['eval_top1'] for r in evals]}; {card}")
    return out


def phase_recipe_variants(workdir: str, card: str) -> dict:
    """Phase 47 (freeze and skip): ``--freeze-backbone --grad-clip 1`` for 2
    steps (every backbone leaf the init bit for bit, the head moved);
    ``--skip-nonfinite`` over a static pair of batches whose second holds a
    NaN in every image (steps 1 and 3 skipped: the archive's counters (1,
    False, 2) and adam count 2, every param finite).  -> launch counts."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.utils import flatten_tree

    out = {}
    init, saved = f"{workdir}/init.npz", f"{workdir}/frozen.npz"
    checkpoint.save_npz(synth_params(VIT_B_16, 0), init)
    out["train_recipe_freeze"], losses = _train_cli(
        workdir, ["--init-weights", init, "--freeze-backbone", "--grad-clip", "1.0", "--lr",
                  str(TRAIN_LR), "--save", saved], 2)
    _expect_counts_of(out["train_recipe_freeze"],
                      {k: 24 for k in ("ln_qkv_attn", *TRAIN_KERNELS)}, "train cli freeze")
    want = flatten_tree(load_params_any(init, VIT_B_16, round_to_6dp=True))
    got = flatten_tree(checkpoint.load_npz(saved))
    moved = [k for k in want if not np.array_equal(got[k], want[k])]
    if sorted(moved) != ["head/bias", "head/kernel"]:
        raise RuntimeError(f"--freeze-backbone: leaves that moved {moved}, expected the head's")
    log(f"train cli --freeze-backbone --grad-clip 1 (B/16 b64 bf16, AdamW {TRAIN_LR}): losses "
        f"{losses}; {len(want) - 2} backbone leaves the init bit for bit, the head's 2 moved; "
        f"{card}")

    x = synth_images(128, VIT_B_16, seed=9)
    x[64:, 0, 0, 0] = np.nan  # the second batch: a NaN in every image
    y = (np.arange(128) * 7 % VIT_B_16.num_classes).astype("<i4")
    with open(f"{workdir}/nan.bin", "wb") as fh:
        np.array(x.shape, "<i4").tofile(fh)
        x.astype("<f4").tofile(fh)
    y.tofile(f"{workdir}/nan.labels.bin")
    state = f"{workdir}/skip.npz"
    out["train_recipe_skip"], losses = _train_cli(
        workdir, ["--input", f"{workdir}/nan.bin", "--labels", f"{workdir}/nan.labels.bin",
                  "--skip-nonfinite", "--lr", str(TRAIN_LR), "--save-state", state], 4,
        finite=False)
    _expect_counts_of(out["train_recipe_skip"],
                      {k: 48 for k in ("ln_qkv_attn", *TRAIN_KERNELS)}, "train cli skip")
    arc = _archive(state)
    counters = (int(arc["opt.0"]), bool(arc["opt.1"]), int(arc["opt.2"]), int(arc["opt.3"]))
    finite = all(np.isfinite(v).all() for k, v in arc.items() if k.startswith("params."))
    log(f"train cli --skip-nonfinite (B/16 b64 bf16, a NaN in every image of the second static "
        f"batch): losses {losses}; archive notfinite_count, last_finite, total_notfinite, adam "
        f"count {counters}; params finite {finite}; {card}")
    if (np.isfinite(losses).tolist() != [True, False, True, False] or counters != (1, False, 2, 2)
            or not finite):
        raise RuntimeError(f"--skip-nonfinite: losses {losses}, counters {counters}, finite "
                           f"params {finite}")
    return out


def recipe_rank_worker(workdir: str) -> None:
    """One rank of phase 47's tensor-parallel runs (``torchrun`` starts
    RANKS of them): tp 2 from the seed for 2 steps with ``--save-state``,
    and tp 2 resuming the one-card archive for 2 more; writes
    ``recipe_rank<r>.json``."""
    import torch.distributed as dist

    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.runtime import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.initialize(backend="gloo")
    _register_tp_config()
    spies = [_FlagSpy(k5.ln_mlp_residual, "partial", False),
             _FlagSpy(k8.ln_mlp_residual_bwd, "residual", True)]
    k5.ln_mlp_residual, k8.ln_mlp_residual_bwd = spies
    tp = ["--tp", "2", "--steps", "2"]
    report = {
        "train_recipe_tp": _train_rank_cli(
            workdir, [*RECIPE_TP_FLAGS, *tp, "--save-state", f"{workdir}/tp_k.npz"], 2, spies),
        "train_recipe_tp_resumed": _train_rank_cli(
            workdir, [*RECIPE_TP_FLAGS, *tp, "--resume", f"{workdir}/one_k.npz", "--save-state",
                      f"{workdir}/tp_km.npz"], 2, spies),
    }
    with open(f"{workdir}/recipe_rank{dist.get_rank()}.json", "w") as fh:
        json.dump(report, fh)


def phase_recipe_tp(workdir: str, card: str) -> dict:
    """Phase 47 (tensor parallel): one card runs B/16 at depth 2, fp32: its
    init saved (0 steps), 2 steps with ``--save-state``, and 2 more resumed;
    two ranks over gloo run tp 2 from the seed and tp 2 resuming the
    one-card step-2 archive, each 2 steps (per rank and step 2 each of K1,
    K5 partial, K6, K8 ``residual=False``); each tp archive and EMA sidecar
    (whole: rank 0 gathers the params and the moments) against the one-card
    ones of its step, under RECIPE_TP_TOL and RECIPE_MOMENT_TOL.  A planted
    one-card resume whose third step trains on another batch must break
    the params', the moments' and the EMA's bounds.  -> rank 0's launch
    counts by path."""
    from vit_tpu_torch.cli.train import main
    from vit_tpu_torch.cli.train_loop import ema_sidecar
    from vit_tpu_torch.config import CONFIGS

    _register_tp_config()
    cfg = CONFIGS[RECIPE_TP_CONFIG]
    one = ["--device", "cuda", *RECIPE_TP_FLAGS]
    at = {n: f"{workdir}/{n}.npz" for n in ("init", "one_k", "one_km", "other3", "planted")}
    with contextlib.redirect_stdout(io.StringIO()):
        rcs = [main([*one, "--steps", "0", "--save-state", at["init"]]),
               main([*one, "--steps", "2", "--save-state", at["one_k"]]),
               main([*one, "--steps", "2", "--resume", at["one_k"], "--save-state",
                     at["one_km"]]),
               # the planted run: step 3 on the batch of another seed, step 4 on its own
               main([*one, "--steps", "1", "--seed", "4", "--resume", at["one_k"],
                     "--save-state", at["other3"]]),
               main([*one, "--steps", "1", "--resume", at["other3"], "--save-state",
                     at["planted"]])]
    if rcs != [0] * 5:
        raise RuntimeError(f"the one-card depth-{RECIPE_TP_DEPTH} runs exited {rcs}")
    _run_ranks("--rank-recipe-worker", workdir, RECIPE_RANKS_TIMEOUT, "recipe ranks")
    reports = [json.load(open(f"{workdir}/recipe_rank{r}.json")) for r in range(RANKS)]
    per_step = {"ln_qkv_attn": RECIPE_TP_DEPTH, "ln_mlp_residual": RECIPE_TP_DEPTH,
                "ln_qkv_attn_bwd": RECIPE_TP_DEPTH, "ln_mlp_residual_bwd": RECIPE_TP_DEPTH}
    for r, rep in enumerate(reports):
        for path, run in rep.items():
            if run["rc"] != 0:
                raise RuntimeError(f"rank {r} {path}: the train CLI exited {run['rc']}")
            _expect_cli(run["launches"], per_step, 2, f"rank {r} {path} (depth 2, 2 steps)")
            _expect_flags(run["flags"], 2 * RECIPE_TP_DEPTH, f"rank {r} {path}")

    def held(got: str, want: str, start: str) -> tuple:
        """Two runs of 2 steps from ``start``: -> (the state's and the EMA's
        leaves out of bounds, the worst ratios)."""
        state = _tp_mismatches(_archive(got), _archive(want), _archive(start), cfg, 2)
        ema = _tp_mismatches(*(_archive(ema_sidecar(p)) for p in (got, want, start)), cfg, 2)
        return state[0] + ema[0], {**state[1], **ema[1]}

    for tp, one_k, start, step in (("tp_k", "one_k", "init", 2), ("tp_km", "one_km", "one_k", 4)):
        bad, worst = held(f"{workdir}/{tp}.npz", at[one_k], at[start])
        log(f"recipe tp 2 (B/16 widths, depth {RECIPE_TP_DEPTH}, b{TP_TRAIN_BATCH} fp32, AdamW "
            f"{TRAIN_LR}, EMA 0.999) {tp}.npz vs the one-card {one_k}.npz (step {step}, 2 steps "
            f"from {start}.npz): worst share of each bound {_worst_text(worst)}; {card}")
        if bad:
            raise RuntimeError(f"{tp} vs {one_k}: {len(bad)} leaves out of bounds: {bad[:6]}")
    bad, worst = held(at["planted"], at["one_km"], at["one_k"])
    log(f"recipe tp check, planted (one card, step 3 on another batch) vs one_km.npz: worst "
        f"share of each bound {_worst_text(worst)}; {len(bad)} leaves out of bounds; {card}")
    blind = [cls for cls in ("params", "moments", "ema") if not worst.get(cls, (0.0,))[0] > 1.0]
    if blind:
        raise RuntimeError(f"the tp check's {blind} bounds cannot see a step on another batch: "
                           f"{_worst_text(worst)}")
    return {path: reports[0][path]["launches"] for path in reports[0]}


def phase_recipe_times(workdir: str, dev: torch.device, card: str) -> None:
    """Phase 47 (times): the B/16 b64 bf16 ``fused_train`` step with K20,
    plain and with the recipe (augment crop,flip,mixup,cutmix inside the
    step and the EMA 0.999 after it): host wall per step (median, in
    turns) and profiler device time; the augmentation's and the EMA's
    device time alone; the time to gather and write a B/16 train state
    (FusedAdamW's moments and the EMA)."""
    from vit_tpu_torch.cli.train_setup import _detached
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer
    from vit_tpu_torch.runtime.augment import make_augment_fn

    cfg = VIT_B_16
    x = torch.from_numpy(synth_images(64, cfg, seed=4)).to(dev)
    y = torch.arange(64, device=dev) * 7 % cfg.num_classes
    augment = make_augment_fn(["crop", "flip", "mixup", "cutmix"], cfg.num_classes)

    def make(recipe: bool):
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        opt = trainer.FusedAdamW(list(trainer.leaves(params)), lr=TRAIN_LR)
        step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                       compute_dtype=torch.bfloat16,
                                       rng=torch.Generator().manual_seed(0),
                                       augment_fn=augment if recipe else None)
        ema = _detached(params)
        update = trainer.make_ema_update(0.999)
        calls = iter(range(10 ** 6))

        def run():
            loss = step(params, x, y, step=next(calls))
            if recipe:
                update(ema, params)
            return float(loss)

        return run, params, opt, ema, update

    runs = {"plain": make(False), "recipe": make(True)}
    for run, *_ in runs.values():
        run()
        run()
    walls = {k: [] for k in runs}
    for _ in range(4):
        for k in ("plain", "recipe", "recipe", "plain"):
            t0 = time.perf_counter()
            runs[k][0]()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    device = {k: _device_ms(runs[k][0], steps=5) for k in runs}
    gen = torch.Generator().manual_seed(1)
    aug_ms = _device_ms(lambda: augment(gen, x, y), steps=10)
    enqueue = []  # host ms to queue the augmentation, the card idle before
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        augment(gen, x, y)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    _, params, opt, ema, update = runs["recipe"]
    ema_ms = _device_ms(lambda: update(ema, params), steps=10)
    ema_event_ms = cuda_ms(lambda: update(ema, params))
    # the EMA reads the EMA and the params and writes the EMA, fp32
    ema_bound = 3 * 4 * B16_LEAVES[1] / HBM_BYTES_PER_S * 1e3
    wall = {k: statistics.median(v) for k, v in walls.items()}
    log(f"recipe step B/16 b64 bf16 fused_train fused_adamw: plain {wall['plain']:.6g} ms wall "
        f"(median of 8, in turns), {device['plain']:.6g} ms device; with augment "
        f"crop,flip,mixup,cutmix and EMA 0.999 {wall['recipe']:.6g} ms wall, "
        f"{device['recipe']:.6g} ms device ({64 / wall['recipe'] * 1e3:.6g} img/s vs "
        f"{64 / wall['plain'] * 1e3:.6g}); the augmentation alone {aug_ms:.6g} ms device (b64, "
        f"mean over mixup and cutmix draws), {statistics.median(enqueue):.6g} ms host to queue "
        f"it (median of 10); the EMA alone {ema_ms:.6g} ms device, {ema_event_ms:.6g} ms by "
        f"CUDA events (median of 10), bound {ema_bound:.6g} ({B16_LEAVES[1]:,} fp32 elements); "
        f"{card}")
    t0 = time.perf_counter()
    leaves = trainer.opt_state_leaves(opt, params)
    tree = params_to_numpy(params)
    t1 = time.perf_counter()
    path = f"{workdir}/state.npz"
    checkpoint.save_train_state(tree, leaves, 10, path)
    checkpoint.save_npz(params_to_numpy(ema), f"{workdir}/state.ema.npz")
    t2 = time.perf_counter()
    size = os.path.getsize(path) + os.path.getsize(f"{workdir}/state.ema.npz")
    log(f"B/16 train state write (FusedAdamW): {t1 - t0:.6g} s to gather params and moments to "
        f"the host, {t2 - t1:.6g} s to write the archive and the EMA sidecar ({size / 1e6:.6g} "
        f"MB, {len(leaves)} optimizer leaves) into the build directory (page cache, not synced); "
        f"{card}")


def group_recipe(dev, card, summary, launches) -> None:
    """Phase 47."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images

    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        images = synth_images(sum(DATA_SHARDS), VIT_B_16, seed=7)
        labels = np.random.default_rng(7).integers(0, VIT_B_16.num_classes, len(images))
        _write_shards(workdir, images, labels)
        del images
        launches.update(phase_recipe_resume(workdir, card))
        torch.cuda.empty_cache()
        launches.update(phase_recipe_variants(workdir, card))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        launches.update(phase_recipe_tp(workdir, card))
        torch.cuda.empty_cache()
        phase_recipe_times(workdir, dev, card)


# phase 48: pipeline and sequence parallelism, ranks sharing the card over gloo
PP_SP_TIMEOUT = 300  # s: a rank that hangs fails phase 48
PP_FWD_BATCH, PP_BATCH, PP_MB = 100, 16, 4  # the fused forward's, the train step's; microbatches
PP_SP_STEPS = 2  # the train CLI's steps on the pp and sp runs
SP_BATCH, SP_LONG_BATCH, SP_FWD_BATCH = 16, 2, 8
PPTP_DEPTH, PPTP_BATCH, PPTP_MB = 4, 16, 2  # pp 2 x tp 2 (4 ranks) at B/16 widths
PP_REG_SEED = 48
# per rank (and step): 6 layers a stage x the microbatches that stage computes
PP_LAYERS = 12 // RANKS
PP_RUNS = {  # name: (mesh flags, flags, launches per step, steps, ops of the one-card run)
    "train_pp": (["--pp", "2", "--microbatches", str(PP_MB)], ["--batch", str(PP_BATCH)],
                 {"ln_qkv_attn": PP_LAYERS * PP_MB,
                  **{name: PP_LAYERS * PP_MB for name in TRAIN_KERNELS}}, PP_SP_STEPS,
                 "fused_train"),
    "train_pp_regularized": (["--pp", "2", "--microbatches", "1"],
                             ["--batch", str(PP_BATCH), *REG_FLAGS],
                             {"ln_qkv_attn": PP_LAYERS, "ln_qkv_attn_bwd": PP_LAYERS,
                              **{name: PP_LAYERS for name in REG_KERNELS}}, 1, "fused_train"),
    "train_sp": (["--sp", "2"], ["--batch", str(SP_BATCH), "--mixed-precision"],
                 {name: 12 for name in ("out_residual", "ln_mlp_residual", "out_residual_bwd",
                                        "ln_mlp_residual_bwd")}, PP_SP_STEPS, "eager"),
}
# the CLI losses against the one-card run's: fp32 steps 0 (the same params) and
# 1 (after an AdamW step whose rounding-level gradients move by a sign); bf16
# mixed against eager, the reference's bf16 spread
PP_LOSS_TOL = {"train_pp": (1e-4, 1e-3), "train_pp_regularized": (1e-4,),
               "train_sp": (2e-2, 2e-2)}
PP_FWD_LAUNCHES = {"ln_qkv_attn": PP_LAYERS * PP_MB, "out_ln_mlp_residual": PP_LAYERS * PP_MB}
SP_STEP = PP_RUNS["train_sp"][2]
PPTP_LAYERS = PPTP_DEPTH // 2
PPTP_QUANT = {name: PPTP_LAYERS * PPTP_MB for name in ("ln_qkv_attn_q8", *TP_KERNELS)}
PPTP_TRAIN = {name: PPTP_LAYERS * PPTP_MB for name in ("ln_qkv_attn", "ln_mlp_residual",
                                                        "ln_qkv_attn_bwd", "ln_mlp_residual_bwd")}


def _pp_sp_batch(dev, cfg, n: int, seed: int):
    from vit_tpu_torch.io.images import synth_images

    x = torch.from_numpy(synth_images(n, cfg, seed=seed)).to(dev)
    y = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.num_classes, n)).to(dev)
    return x, y


def _sgd0(params):
    """SGD at lr 0: the step leaves the params and keeps the gradients."""
    from vit_tpu_torch.runtime.trainer import leaves

    return torch.optim.SGD(list(leaves(params)), lr=0.0)


def _step_times(step, dev, rounds: int = 3) -> tuple:
    """(median wall ms of ``rounds`` synchronized steps after one warmup, the
    profiler's device ms of one step); on a mesh the ranks start together."""
    import torch.distributed as dist

    walls = []
    for _ in range(rounds + 1):
        if dist.is_initialized():
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[1:]) * 1e3, _device_ms(step, 2)


def _grads_of(workdir, name, rank, tree, mesh) -> None:
    """Gather the gradient tree over ``mesh`` (a collective) and, on rank 0,
    save it as ``name``.npz."""
    from vit_tpu_torch.parallel.sharding import unshard_params

    grads = unshard_params(_grad_tree(tree), mesh)
    if rank == 0:
        np.savez(f"{workdir}/{name}.npz", **{p: g.float().cpu().numpy() for p, g in _paths(grads)})


def _lib_step(report, name, make_step, tree, x, y, want):
    """One library train step with every count set to 0 just before and
    read just after -> its loss into ``report``."""
    wrappers = _reset_counts()
    loss = float(make_step(tree)(tree, x, y))
    torch.cuda.synchronize()
    report["runs"][name] = {"rc": 0 if np.isfinite(loss) else 1, "loss": loss,
                            "launches": {n: fn.launches for n, fn in wrappers.items()}}
    report["want"][name] = want


def _one_card_losses(workdir: str, flags, steps: int) -> list:
    """The losses of the one-card train CLI (B/16) with ``flags``."""
    from vit_tpu_torch.cli.train import main

    path = f"{workdir}/one_card.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["--config", "vit_b_16", "--steps", str(steps), "--device", "cuda",
                   "--log-jsonl", path, *flags])
    if rc != 0:
        raise RuntimeError(f"the one-card train CLI {flags} exited {rc}")
    with open(path) as fh:
        losses = [json.loads(line)["loss"] for line in fh]
    os.remove(path)
    return losses


def pp_sp_rank_worker(workdir: str) -> None:
    """One rank of phase 48 (``torchrun`` starts 2, then 4): on 2 ranks the
    shift's bits, the pp 2 ``fused`` forward, the train CLI runs of
    ``PP_RUNS``, the gradients of the pp 2 (plain and regularized) and sp 2
    ``fused_train`` steps, the sp steps' bf16 losses @224 and @512, the sp 2
    eager forward and the steps' times; on 4 ranks the pp 2 x tp 2 ``quant``
    forward and ``fused_train`` gradients at depth 4.  Writes
    ``pp_sp_rank<r>_of<n>.json`` (rank 0: the logits and gradients)."""
    import torch.distributed as dist

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.parallel.mesh import shift
    from vit_tpu_torch.parallel.pipeline import make_pp_train_step, shard_forward_pp
    from vit_tpu_torch.parallel.sequence import make_sp_train_step, shard_forward_sp
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.runtime import distributed, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.initialize(backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    report = {"runs": {}, "want": {}, "flags": {}, "ms": {}}
    cfg = VIT_B_16

    def init(c, mesh):
        tree = vit.init_params(torch.Generator().manual_seed(0), c)
        return trainer.as_trainable(shard_params(tree, mesh) if mesh is not None else tree, dev)

    if world == 4:
        # pp 2 x tp 2 at depth 4: the quant forward and the fused_train gradients
        c4 = dataclasses.replace(cfg, depth=PPTP_DEPTH, name="vit_b_16_depth4")
        mesh = make_mesh({"pp": 2, "tp": 2})
        q = quant.cast_quantized_params(quant.quantize_params(
            params_from_numpy(synth_params(c4, 0), dev, torch.float32)), torch.bfloat16)
        x, y = _pp_sp_batch(dev, c4, PPTP_BATCH, 11)
        fwd = shard_forward_pp(c4, mesh, PPTP_MB, ops_name="quant")
        local = shard_params(q, mesh)
        wrappers = _reset_counts()
        logits = fwd(local, x.to(torch.bfloat16)).float().cpu().numpy()
        torch.cuda.synchronize()
        report["runs"]["classify_quant_tp_pp"] = {
            "rc": 0, "launches": {n: fn.launches for n, fn in wrappers.items()}}
        report["want"]["classify_quant_tp_pp"] = PPTP_QUANT
        del q, local
        spies = [_FlagSpy(k5.ln_mlp_residual, "partial", False),
                 _FlagSpy(k8.ln_mlp_residual_bwd, "residual", True)]
        k5.ln_mlp_residual, k8.ln_mlp_residual_bwd = spies
        tree = init(c4, mesh)
        _lib_step(report, "train_tp_pp", lambda p: make_pp_train_step(
            c4, _sgd0(p), mesh, PPTP_MB, ops_name="fused_train"), tree, x, y, PPTP_TRAIN)
        report["flags"]["train_tp_pp"] = {s.flag: [sum(s.values), len(s.values)] for s in spies}
        _grads_of(workdir, "grads_tp_pp", rank, tree, mesh)
        if rank == 0:
            np.save(f"{workdir}/logits_quant_tp_pp.npy", logits)
        with open(f"{workdir}/pp_sp_rank{rank}_of4.json", "w") as fh:
            json.dump(report, fh)
        return

    # 1. the cyclic shift, fp32 and bf16 (signed zero, inf, NaN): what each
    # rank sent and received, as raw bits
    pp = make_mesh({"pp": 2})
    sent = torch.arange(-8, 8, dtype=torch.float32, device=dev).reshape(4, 4) * (rank + 1)
    sent[0, :3] = torch.tensor([-0.0, float("inf"), float("nan")])
    report["shift"] = {}
    for t, ints in ((sent, torch.int32), (sent.to(torch.bfloat16), torch.int16)):
        got = shift(t, pp, "pp", 1)
        back = shift(got, pp, "pp", -1)
        report["shift"][str(t.dtype)] = [t.view(ints).flatten().tolist(),
                                         got.view(ints).flatten().tolist(),
                                         back.view(ints).flatten().tolist()]

    # 2. the pp 2 fused forward, B/16 @224 batch 100 bf16, 4 microbatches
    from vit_tpu_torch.io.images import synth_images

    pbf = vit.cast_params(params_from_numpy(synth_params(cfg, 0), dev, torch.float32),
                          torch.bfloat16)
    local = shard_params(pbf, pp)
    x100 = torch.from_numpy(synth_images(PP_FWD_BATCH, cfg, seed=1)).to(dev, torch.bfloat16)
    fwd = shard_forward_pp(cfg, pp, PP_MB, ops_name="fused")
    fwd(local, x100)
    torch.cuda.synchronize()
    wrappers = _reset_counts()
    logits = fwd(local, x100).float().cpu().numpy()
    torch.cuda.synchronize()
    report["runs"]["classify_pp"] = {"rc": 0, "launches": {n: f.launches
                                                           for n, f in wrappers.items()}}
    report["want"]["classify_pp"] = PP_FWD_LAUNCHES
    report["ms"]["classify_pp"] = _step_times(lambda: fwd(local, x100), dev)
    if rank == 0:
        np.save(f"{workdir}/logits_pp.npy", logits)
    del pbf, local, x100
    torch.cuda.empty_cache()

    # 3. the train CLI: pp 2 fp32 (plain, regularized) and sp 2 bf16 mixed
    for name, (mesh_flags, flags, _, steps, _) in PP_RUNS.items():
        report["runs"][name] = _train_rank_cli(workdir, [*mesh_flags, *flags], steps, [])
        torch.cuda.empty_cache()

    # 4. gradients of one step (SGD at lr 0), gathered: pp 2 plain and
    # regularized, sp 2 fp32; the sp steps' bf16 losses @224 and @512
    x, y = _pp_sp_batch(dev, cfg, PP_BATCH, 3)
    tree = init(cfg, pp)
    pp_step = make_pp_train_step(cfg, _sgd0(tree), pp, PP_MB, ops_name="fused_train")
    _lib_step(report, "grads_pp", lambda p: pp_step, tree, x, y, PP_RUNS["train_pp"][2])
    _grads_of(workdir, "grads_pp", rank, tree, pp)
    report["ms"]["train_pp"] = _step_times(lambda: pp_step(tree, x, y), dev)
    del tree, pp_step
    reg = dataclasses.replace(cfg, dropout=REG_P, drop_path=REG_P)
    tree = init(reg, pp)
    _lib_step(report, "grads_pp_regularized", lambda p: make_pp_train_step(
        reg, _sgd0(p), pp, 1, ops_name="fused_train", use_dropout=True,
        rng=torch.Generator().manual_seed(PP_REG_SEED)), tree, x, y,
        PP_RUNS["train_pp_regularized"][2])
    _grads_of(workdir, "grads_pp_regularized", rank, tree, pp)
    del tree
    sp = make_mesh({"sp": 2})
    tree = init(cfg, None)
    _lib_step(report, "grads_sp", lambda p: make_sp_train_step(
        cfg, _sgd0(p), sp, ops_name="fused_train"), tree, x, y, SP_STEP)
    if rank == 0:
        np.savez(f"{workdir}/grads_sp.npz",
                 **{p: g.float().cpu().numpy() for p, g in _paths(_grad_tree(tree))})
    sp_step = make_sp_train_step(cfg, _sgd0(tree), sp, ops_name="fused_train",
                                 compute_dtype=torch.bfloat16)
    _lib_step(report, "loss_sp_bf16", lambda p: sp_step, tree, x, y, SP_STEP)
    report["ms"]["train_sp"] = _step_times(lambda: sp_step(tree, x, y), dev)
    del tree, sp_step
    torch.cuda.empty_cache()
    c512 = cfg.with_image_size(LONG_IMAGE)
    xl, yl = _pp_sp_batch(dev, c512, SP_LONG_BATCH, 5)
    tree = init(c512, None)
    _lib_step(report, "train_sp_long", lambda p: make_sp_train_step(
        c512, _sgd0(p), sp, ops_name="fused_train", compute_dtype=torch.bfloat16), tree, xl, yl,
        SP_STEP)
    del tree
    torch.cuda.empty_cache()

    # 5. the sp 2 eager forward, fp32 @224
    p32 = params_from_numpy(synth_params(cfg, 0), dev, torch.float32)
    x8 = torch.from_numpy(synth_images(SP_FWD_BATCH, cfg, seed=1)).to(dev)
    with torch.no_grad():
        logits = shard_forward_sp(cfg, sp)(p32, x8).cpu().numpy()
    if rank == 0:
        np.save(f"{workdir}/logits_sp.npy", logits)
    with open(f"{workdir}/pp_sp_rank{rank}_of2.json", "w") as fh:
        json.dump(report, fh)


def _check_pp_sp_report(rep: dict, r: int, n: int) -> None:
    for name, run in rep["runs"].items():
        if run["rc"] != 0:
            raise RuntimeError(f"rank {r} of {n} {name}: exited {run['rc']} or non-finite")
        if name in PP_RUNS:
            steps = PP_RUNS[name][3]
            _expect_cli(run["launches"], PP_RUNS[name][2], steps, f"rank {r} {name} (B/16, "
                        f"{steps} step(s))")
            log(f"rank {r} {name}: per step {_per_step(run['launches'], steps)}")
        else:
            _expect_counts_of(run["launches"], rep["want"][name], f"rank {r} of {n} {name}")


def phase_pp_sp(dev: torch.device, card: str, workdir: str) -> dict:
    """Phase 48: pipeline and sequence parallelism, ranks sharing the card
    over gloo (``torchrun`` with a time limit, ``--rank-pp-sp-worker``):
    counts per rank and step against the design, the pp and sp results
    against the one-card paths', the steps' times beside the one-card
    steps'.  -> launch counts of rank 0 by path."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime import trainer
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    _run_ranks("--rank-pp-sp-worker", workdir, PP_SP_TIMEOUT, "pp/sp ranks")
    _run_ranks("--rank-pp-sp-worker", workdir, PP_SP_TIMEOUT, "pp x tp ranks", ranks=4)
    reports = {(r, n): json.load(open(f"{workdir}/pp_sp_rank{r}_of{n}.json"))
               for n in (2, 4) for r in range(n)}
    for (r, n), rep in reports.items():
        _check_pp_sp_report(rep, r, n)
        if n == 4:
            _expect_flags(rep["flags"]["train_tp_pp"], PPTP_LAYERS * PPTP_MB,
                          f"rank {r} of 4 train_tp_pp")
    for dtype in ("torch.float32", "torch.bfloat16"):
        bits = [reports[r, 2]["shift"][dtype] for r in range(2)]
        # rank r receives rank r - 1's tensor, and the shift back returns its own
        same = all(bits[r][1] == bits[1 - r][0] and bits[r][2] == bits[r][0] for r in range(2))
        log(f"shift over gloo on the card, {dtype} (signed zero, inf, NaN): received == sent "
            f"{'bit for bit' if same else 'NOT bit for bit'} on both ranks")
        if not same:
            raise RuntimeError(f"the shift over gloo on the card changed {dtype} bits")

    # the pp 2 fused forward against the one-card fused engine, bf16
    params = synth_params(cfg, 0)
    images = synth_images(PP_FWD_BATCH, cfg, seed=1)
    one = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=PP_FWD_BATCH)
    want = one.logits(images).float().cpu().numpy()
    got = np.load(f"{workdir}/logits_pp.npy")
    dev_pp = float(np.abs(got - want).max())
    log(f"pp 2 fused bf16 @224 b{PP_FWD_BATCH} m {PP_MB} vs one-card fused bf16: max|d logit|="
        f"{dev_pp:.6g} (tol 0.027, the reference's bf16 spread)")
    _comparator_rule("pp 2 fused bf16 vs one-card fused bf16", _probs(got), _probs(want))
    one_ms = _step_times(lambda: one.logits(images), dev)
    del one
    torch.cuda.empty_cache()
    if not dev_pp <= 0.027:
        raise RuntimeError("pp 2 fused logits outside the bf16 spread of the one-card engine's")

    def hold(name, cfg_, x, y, ops, compute_dtype=None, rng_seed=None):
        tree = vit.init_params(torch.Generator().manual_seed(0), cfg_)
        loss1, ref = _grads(cfg_, tree, x, y, ops, compute_dtype, dev, rng_seed)
        got = {k: torch.from_numpy(v).to(dev) for k, v in np.load(f"{workdir}/{name}.npz").items()}
        worst, leaf = _worst_leaf(got, ref)
        loss = reports[0, 4 if name == "grads_tp_pp" else 2]["runs"][
            "train_tp_pp" if name == "grads_tp_pp" else name]["loss"]
        log(f"{name}: fp32 grads (gathered) vs one-card {ops}: loss {loss:.7g} vs {loss1:.7g} "
            f"(|d| {abs(loss - loss1):.3g}, tol 1e-4); {len(ref)} leaves, worst {leaf or '(none)'} at "
            f"{worst:.3g} of its bound (1e-3 x max(1, max|g|))")
        if worst > 1.0 or set(got) != set(ref) or not abs(loss - loss1) <= 1e-4:
            raise RuntimeError(f"{name}: gradients or loss outside the one-card step's bounds")

    x, y = _pp_sp_batch(dev, cfg, PP_BATCH, 3)
    hold("grads_pp", cfg, x, y, "fused_train")
    hold("grads_pp_regularized", dataclasses.replace(cfg, dropout=REG_P, drop_path=REG_P), x, y,
         "fused_train", rng_seed=trainer.fold_in(PP_REG_SEED, 0))
    hold("grads_sp", cfg, x, y, "eager")
    tree = vit.init_params(torch.Generator().manual_seed(0), cfg)
    for name, c, (xb, yb) in (("loss_sp_bf16", cfg, (x, y)),
                              ("train_sp_long", cfg.with_image_size(LONG_IMAGE),
                               _pp_sp_batch(dev, cfg.with_image_size(LONG_IMAGE),
                                            SP_LONG_BATCH, 5))):
        t = tree if c is cfg else vit.init_params(torch.Generator().manual_seed(0), c)
        loss1 = _grads(c, t, xb, yb, "eager", torch.bfloat16, dev)[0]
        loss = reports[0, 2]["runs"][name]["loss"]
        log(f"{name}: sp 2 fused_train bf16 mixed loss {loss:.7g} vs one-card eager {loss1:.7g} "
            f"(|d| {abs(loss - loss1):.3g}, tol 2e-2)")
        if not abs(loss - loss1) <= 2e-2:
            raise RuntimeError(f"{name}: loss outside 2e-2 of the one-card eager step's")
        torch.cuda.empty_cache()

    # the pp 2 x tp 2 quant forward and fused_train gradients at depth 4
    c4 = dataclasses.replace(cfg, depth=PPTP_DEPTH, name="vit_b_16_depth4")
    x4, y4 = _pp_sp_batch(dev, c4, PPTP_BATCH, 11)
    q1 = InferenceEngine(c4, synth_params(c4, 0), "bfloat16", "quant", dev, batch_pad=PPTP_BATCH)
    _comparator_rule(f"pp 2 x tp 2 quant bf16 (depth {PPTP_DEPTH}) vs one-card quant bf16",
                     _probs(np.load(f"{workdir}/logits_quant_tp_pp.npy")),
                     _probs(q1.logits(x4.cpu().numpy()).float().cpu().numpy()))
    del q1
    hold("grads_tp_pp", c4, x4, y4, "fused_train")

    # the sp 2 eager forward against the one-card eager forward, fp32
    with torch.no_grad():
        want = vit.forward(params_from_numpy(params, dev, torch.float32),
                           torch.from_numpy(synth_images(SP_FWD_BATCH, cfg, seed=1)).to(dev),
                           cfg).cpu().numpy()
    dev_sp = float(np.abs(np.load(f"{workdir}/logits_sp.npy") - want).max())
    log(f"sp 2 eager fp32 @224 b{SP_FWD_BATCH} vs one-card eager fp32: max|d logit|="
        f"{dev_sp:.6g} (tol 1e-4)")
    if not dev_sp <= 1e-4:
        raise RuntimeError("sp 2 eager logits outside 1e-4 of the one-card forward's")

    # the CLI runs' losses against the one-card CLI's on the same batches
    for name, (_, flags, _, steps, ops) in PP_RUNS.items():
        got = [rec["loss"] for rec in reports[0, 2]["runs"][name]["steps"]]
        want = _one_card_losses(workdir, [*flags, "--ops", ops], steps)
        log(f"{name}: the CLI's losses {got} vs one-card {ops} {want} (tol "
            f"{PP_LOSS_TOL[name]})")
        if len(got) != steps or not all(abs(a - b) <= tol for a, b, tol
                                         in zip(got, want, PP_LOSS_TOL[name])):
            raise RuntimeError(f"{name}: the CLI's losses outside the one-card run's bounds")
        torch.cuda.empty_cache()

    # times: two ranks sharing one card over gloo, not scaling figures
    from vit_tpu_torch.ops.dispatch import get_ops

    one_step = {}
    for name, dtype in (("train_pp", None), ("train_sp", torch.bfloat16)):
        tr = trainer.as_trainable(tree, dev)
        step = trainer.make_train_step(cfg, _sgd0(tr), get_ops("fused_train"), remat=False,
                                       compute_dtype=dtype)
        one_step[name] = _step_times(lambda: step(tr, x, y), dev)
        del tr, step
        torch.cuda.empty_cache()
    ms = reports[0, 2]["ms"]
    log(f"pp 2 fused bf16 forward b{PP_FWD_BATCH}: {ms['classify_pp'][0]:.6g} ms wall, "
        f"{ms['classify_pp'][1]:.6g} ms device (rank 0) against one card's {one_ms[0]:.6g} / "
        f"{one_ms[1]:.6g}; two ranks sharing one card over gloo, not a scaling figure; {card}")
    for name, what in (("train_pp", f"pp 2 fused_train fp32 step b{PP_BATCH} m {PP_MB}"),
                       ("train_sp", f"sp 2 fused_train bf16 mixed step b{SP_BATCH}")):
        log(f"{what}: {ms[name][0]:.6g} ms wall, {ms[name][1]:.6g} ms device (rank 0) against "
            f"one card's {one_step[name][0]:.6g} / {one_step[name][1]:.6g}; two ranks sharing "
            f"one card over gloo, not a scaling figure; {card}")
    for name in PP_RUNS:
        log(f"{name} rank 0: " + " / ".join(reports[0, 2]["runs"][name]["stdout"]))
    launches = {name: reports[0, 2]["runs"][name]["launches"]
                for name in ("classify_pp", *PP_RUNS, "train_sp_long")}
    launches.update({name: reports[0, 4]["runs"][name]["launches"]
                     for name in ("classify_quant_tp_pp", "train_tp_pp")})
    return launches


def group_pp_sp(dev, card, summary, launches) -> None:
    """Phase 48."""
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        launches.update(phase_pp_sp(dev, card, workdir))


# -- serving over a mesh and the lockstep server (phase 49) ---------------------

MESH_SERVE_TIMEOUT = 420  # s: a rank that hangs fails phase 49
MESH_SERVE_REQUESTS = 64  # of phase 39's stream: 1-64 images each
# tp 2 over gloo costs ~1 s a batch on one card (24 activation all-reduces
# of up to 39 MB through host memory): the tp runs serve the stream's first 16
MESH_SERVE_TP_REQUESTS = 16
MESH_SERVE_FP32_REQUESTS = 8
# the InferenceServer runs: name -> (mesh axes, ops, dtype, requests, launches per batch)
MESH_SERVE_RUNS = {
    "serve_tp": ({"dp": 1, "tp": 2}, "fused", "bfloat16", MESH_SERVE_TP_REQUESTS,
                 {"ln_qkv_attn": 12, "ln_mlp_residual": 12, "layer_norm": 1}),
    "serve_quant_tp": ({"dp": 1, "tp": 2}, "quant", "bfloat16", MESH_SERVE_TP_REQUESTS,
                       {"ln_qkv_attn_q8": 12, "ln_fc1_gelu_q8": 12, "fc2_q8_partial": 12,
                        "layer_norm": 1}),
    "serve_dp": ({"dp": 2, "tp": 1}, "fused", "bfloat16", MESH_SERVE_REQUESTS,
                 {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}),
    "serve_tp_fp32": ({"dp": 1, "tp": 2}, "fused", "float32", MESH_SERVE_FP32_REQUESTS,
                      {"ln_qkv_attn": 12, "ln_mlp_residual": 12, "layer_norm": 1}),
}
LOCKSTEP_BATCH = 32  # local_batch: each rank's images per tick
LOCKSTEP_TICK_MS = 10.0
LOCKSTEP_REQUESTS = 24  # per rank, 1-32 images each, from the rank's own seed
LOCKSTEP_LATE = 10  # rank 0's requests queued when rank 1 stops
LOCKSTEP_IDLE_S = 1.0
LOCKSTEP_TICK = {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}
MULTIHOST_LOCAL_BATCH = 8  # the serve CLI's --multihost daemons; 8 images a POST
MULTIHOST_TRAIN = {"ln_qkv_attn": RECIPE_TP_DEPTH,
                   **{name: RECIPE_TP_DEPTH for name in TRAIN_KERNELS}}
MULTIHOST_STEPS = 3
MULTIHOST_FLAGS = ["--config", RECIPE_TP_CONFIG, "--batch", str(TP_TRAIN_BATCH), "--ops",
                   "fused_train", "--mixed-precision", "--steps", str(MULTIHOST_STEPS),
                   "--device", "cuda", "--dist-backend", "gloo", "--lr", str(TRAIN_LR)]


def _lockstep_stream(rank: int, late: bool = False) -> list:
    """Rank ``rank``'s lockstep requests, (offset, size) slices of the pool:
    LOCKSTEP_REQUESTS of 1-32 images from ``default_rng(100 + rank)``, or
    rank 0's LOCKSTEP_LATE late ones."""
    rng = np.random.default_rng(200 if late else 100 + rank)
    sizes = rng.integers(1, LOCKSTEP_BATCH + 1, LOCKSTEP_LATE if late else LOCKSTEP_REQUESTS)
    return [(int(rng.integers(0, SERVE_POOL - n + 1)), int(n)) for n in sizes]


def _wait_files(paths, timeout: float = SERVE_WAIT) -> None:
    """Wait until every file of ``paths`` exists (the ranks' rendezvous
    while their servers run: no collective may run beside a tick loop)."""
    end = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > end:
            raise RuntimeError(f"no {paths} after {timeout} s")
        time.sleep(0.01)


class _CallSpy:
    """A server's ``_serve_fn`` that counts its calls (the forwards)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _stats_line(stats, images: int, wall: float) -> dict:
    return {"images": images, "wall_s": wall, "img_s": images / wall, "batches": stats.batches,
            "p50_ms": stats.latency.quantile(0.5) * 1e3,
            "p99_ms": stats.latency.quantile(0.99) * 1e3}


def serve_mesh_rank_worker(workdir: str) -> None:
    """One rank of phase 49 (``torchrun`` starts ``RANKS`` of them): the
    ``InferenceServer`` over the meshes of ``MESH_SERVE_RUNS`` (rank 0
    serves phase 39's stream, rank 1 follows), the dp 2 ``LockstepServer``
    (each rank its own requests; one idle second; rank 1 stops while rank
    0 still has requests queued), the serve CLI's daemon on a tp 2 mesh
    (POST /classify, /reload to seed 1, /classify) and the train CLI with
    ``--dp 2`` at depth 2.  Every count is set to 0 just before each run
    and read just after.  Writes ``serve_rank<r>.json`` and its answers
    (``serve_rank<r>.npz``) into ``workdir``."""
    import queue

    import torch.distributed as dist

    from vit_tpu_torch.cli import serve
    from vit_tpu_torch.cli.train import main as train
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime import distributed
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.multihost_serving import LockstepServer
    from vit_tpu_torch.runtime.serving import InferenceServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.initialize(backend="gloo")
    rank = dist.get_rank()
    params = load_params_any(f"{workdir}/params.npz", VIT_B_16)
    pool = np.load(f"{workdir}/pool.npy")
    stream = _serve_stream()
    report, answers = {"runs": {}, "section_s": {}}, {}
    t0 = time.perf_counter()

    def section(name):  # the wall of each part of the worker, for the log
        nonlocal t0
        report["section_s"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    for name, (axes, ops, dtype, count, _) in MESH_SERVE_RUNS.items():
        engine = InferenceEngine(VIT_B_16, params, dtype, ops, dev, batch_pad=SERVE_PAD,
                                 mesh=make_mesh(axes))
        server = InferenceServer(engine, max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_DELAY_MS,
                                 max_queue_images=1 << 31)
        spy = server._serve_fn = _CallSpy(server._serve_fn)
        wrappers = _reset_counts()
        run = {}
        if server.leads:
            server.warmup()  # every padded size, the follower joining each
            fp32 = dtype == "float32"
            with server:
                t0 = time.perf_counter()
                futures = [server.submit(pool[o:o + n], return_probs=fp32)
                           for o, n in stream[:count]]
                got = [f.result(timeout=SERVE_WAIT) for f in futures]
                wall = time.perf_counter() - t0
            run.update(_stats_line(server.stats, sum(n for _, n in stream[:count]), wall))
            answers[f"{name}/labels"] = np.concatenate([g[0] for g in got])
            answers[f"{name}/top"] = np.concatenate([g[1] for g in got])
            if fp32:
                answers[f"{name}/probs"] = np.concatenate([g[2] for g in got])
        else:
            server.follow()
        torch.cuda.synchronize()
        run.update(launches={n: fn.launches for n, fn in wrappers.items()}, forwards=spy.calls)
        report["runs"][name] = run
        del engine, server
        gc.collect()
        torch.cuda.empty_cache()
        section(name)

    # the lockstep server: dp 2, each rank its own requests
    engine = InferenceEngine(VIT_B_16, params, "bfloat16", "fused", dev, batch_pad=SERVE_PAD,
                             mesh=make_mesh({"dp": RANKS}))
    server = LockstepServer(engine, local_batch=LOCKSTEP_BATCH, tick_ms=LOCKSTEP_TICK_MS,
                            max_queue_images=1 << 31)  # each rank's stream queued at once
    spy = server._serve_fn = _CallSpy(server._serve_fn)
    server.warmup()  # every rank together, before start
    torch.cuda.synchronize()
    dist.barrier()
    wrappers = _reset_counts()
    server.start()
    time.sleep(LOCKSTEP_IDLE_S)  # no traffic on any rank: ticks, no forward
    torch.cuda.synchronize()
    report["lockstep_idle"] = {"launches": {n: fn.launches for n, fn in wrappers.items()},
                               "forwards": spy.calls - 1}  # less warmup's
    wrappers, calls0 = _reset_counts(), spy.calls
    open(f"{workdir}/lockstep_ready{rank}", "w").close()
    _wait_files([f"{workdir}/lockstep_ready{r}" for r in range(RANKS)])
    mine = _lockstep_stream(rank)
    t0 = time.perf_counter()
    futures = [server.submit(pool[o:o + n]) for o, n in mine]
    got = [f.result(timeout=SERVE_WAIT) for f in futures]
    wall = time.perf_counter() - t0
    run = _stats_line(server.stats, sum(n for _, n in mine), wall)
    answers["lockstep/labels"] = np.concatenate([g[0] for g in got])
    answers["lockstep/top"] = np.concatenate([g[1] for g in got])
    if rank == 0:  # rank 1 stops while these are queued
        late = [server.submit(pool[o:o + n]) for o, n in _lockstep_stream(0, late=True)]
        open(f"{workdir}/lockstep_queued", "w").close()
        got = [f.result(timeout=SERVE_WAIT) for f in late]
        answers["lockstep_late/labels"] = np.concatenate([g[0] for g in got])
        answers["lockstep_late/top"] = np.concatenate([g[1] for g in got])
    else:
        _wait_files([f"{workdir}/lockstep_queued"])
    t0 = time.perf_counter()
    server.stop()  # returns once every rank has stopped
    run["stop_wait_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    run.update(launches={n: fn.launches for n, fn in wrappers.items()},
               forwards=spy.calls - calls0)
    report["runs"]["serve_lockstep"] = run
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    section("serve_lockstep")

    # the serve CLI's daemon on a tp 2 mesh: rank 0 answers HTTP, rank 1 follows
    args = serve.build_parser().parse_args([
        "--weights", f"{workdir}/params.npz", "--device", "cuda", "--ops", "fused", "--dtype",
        "bfloat16", "--tp", str(RANKS), "--dist-backend", "gloo", "--allow-reload", "--port",
        "0"])
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, ops, server = serve._build_server(args)
    spy = server._serve_fn = _CallSpy(server._serve_fn)
    run = {}
    if server.leads:
        imgs = pool[:8]
        body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
        listening = queue.Queue()
        with contextlib.redirect_stdout(io.StringIO()):
            t = threading.Thread(target=serve._http_daemon, args=(args, cfg, ops, server),
                                 kwargs={"on_listen": listening.put}, daemon=True)
            t.start()
            httpd = listening.get(timeout=SERVE_WAIT)
            port = httpd.server_address[1]
            try:
                for step, path, payload in (
                        ("classify", "/classify", body),
                        ("reload", "/reload", json.dumps({"weights":
                                                         f"{workdir}/params_seed1.npz"})),
                        ("classify_seed1", "/classify", body)):
                    code, out = _http(port, "POST", path, payload)
                    run[f"{step}_code"] = code
                    reply = json.loads(out)
                    if "results" in reply:
                        answers[f"daemon_{step}/labels"] = np.array(
                            [r["label"] for r in reply["results"]])
                        answers[f"daemon_{step}/top"] = np.array(
                            [r["prob"] for r in reply["results"]], np.float32)
            finally:
                httpd.shutdown()
                t.join(timeout=SERVE_WAIT)
        run["stopped"] = not t.is_alive()
    else:
        server.follow()
    torch.cuda.synchronize()
    run.update(launches={n: fn.launches for n, fn in wrappers.items()}, forwards=spy.calls)
    report["runs"]["serve_http_tp"] = run
    del server
    gc.collect()
    torch.cuda.empty_cache()
    section("serve_http_tp")

    # the train CLI with --dp 2 at depth 2: the --multihost processes' reference
    _register_tp_config()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = train([*MULTIHOST_FLAGS, "--dp", str(RANKS), "--data-dir", f"{workdir}/shards",
                    "--log-jsonl", f"{workdir}/train_dp.jsonl"])
    torch.cuda.synchronize()
    report["runs"]["train_dp_depth2"] = {"rc": rc, "launches": {
        n: fn.launches for n, fn in wrappers.items()}}
    section("train_dp_depth2")
    with open(f"{workdir}/serve_rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    np.savez(f"{workdir}/serve_rank{rank}.npz", **answers)


def cli_worker(spec: str) -> None:
    """One process of phase 49's explicit-coordinator runs: the CLIs of
    ``spec.json`` (``[{"cli": "serve" or "train", "argv": [...]}, ...]``) in
    turn in this process (one process group: the first joins it), every
    count set to 0 just before each and read just after, the exit codes
    and counts into ``spec.out.json``."""
    from vit_tpu_torch.cli import serve, train

    with open(f"{spec}.json") as fh:
        jobs = json.load(fh)
    _register_tp_config()
    out = []
    for job in jobs:
        wrappers = _reset_counts()
        rc = (serve if job["cli"] == "serve" else train).main(job["argv"])
        torch.cuda.synchronize()
        out.append({"rc": rc, "launches": {n: fn.launches for n, fn in wrappers.items()}})
        print(f"--cli-worker: {job['cli']} exited {rc}", flush=True)
        if rc:
            break
    with open(f"{spec}.out.json", "w") as fh:
        json.dump(out, fh)
    if out[-1]["rc"]:
        raise SystemExit(out[-1]["rc"])


def _cli_processes(workdir: str, name: str, jobs):
    """Start ``RANKS`` processes running ``jobs`` ([(cli, argv)]) with
    --multihost, joined by explicit --coordinator/--num-processes/
    --process-id (not torchrun), each through ``--cli-worker`` -> the Popen
    objects."""
    import socket
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(RANKS):
        spec = f"{workdir}/{name}{i}"
        flags = ["--multihost", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 str(RANKS), "--process-id", str(i)]
        with open(f"{spec}.json", "w") as fh:
            json.dump([{"cli": cli, "argv": [*argv, *flags]} for cli, argv in jobs], fh)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cli-worker", spec],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
            env=dict(os.environ, OMP_NUM_THREADS="4")))
    return procs


def _kill(procs) -> None:
    import signal

    for p in procs:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.communicate()


def _finish(procs, timeout: float, what: str) -> list:
    """Wait for ``procs`` -> their outputs; past ``timeout`` s every one is
    killed with its process group and the phase fails."""
    end = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(end - time.monotonic(), 1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        _kill(procs)
        raise RuntimeError(f"{what} did not finish in {timeout} s: a process hung")
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if "socket.cpp" not in ln]
        log("\n".join(f"{what} {i}: {ln}" for ln in (lines if p.returncode else lines[-3:])))
        if p.returncode != 0:
            raise RuntimeError(f"{what} process {i} exited {p.returncode}")
    return outs


def phase_multihost(workdir: str, pool, want: tuple, p32: np.ndarray) -> tuple:
    """Two processes joined by explicit coordinator flags (not torchrun),
    each running in turn: the serve CLI with --multihost, its daemon on
    --port 0 (POST /classify with 8 images to each, against the one-card
    engine by the comparator rule; POST /reload answered 409; SIGTERM to
    both: each drains and the lockstep server's stop rendezvous lets both
    return), then the train CLI with --multihost (depth 2, bf16 mixed
    fused_train, the shards).  -> ([each process's serve and train launch
    counts], rank 0's train losses)."""
    import signal

    from vit_tpu_torch.io import results

    serve_argv = ["--weights", f"{workdir}/params.npz", "--device", "cuda", "--ops", "fused",
                  "--dtype", "bfloat16", "--dist-backend", "gloo", "--local-batch",
                  str(MULTIHOST_LOCAL_BATCH), "--allow-reload", "--port", "0"]
    train_argv = [*MULTIHOST_FLAGS, "--data-dir", f"{workdir}/shards", "--log-jsonl",
                  f"{workdir}/train_mh.jsonl"]
    t0 = time.perf_counter()
    procs = _cli_processes(workdir, "mh", [("serve", serve_argv), ("train", train_argv)])
    ports, seen = [], [[] for _ in procs]
    try:
        for i, p in enumerate(procs):  # each daemon prints its port once it listens
            end = time.monotonic() + MESH_SERVE_TIMEOUT
            while True:
                line = p.stdout.readline()
                seen[i].append(line)
                m = re.search(r"listening on http://[\d.]+:(\d+)", line)
                if m:
                    ports.append(int(m.group(1)))
                    break
                if not line or time.monotonic() > end:
                    raise RuntimeError(f"--multihost daemon {i} did not listen: "
                                       + "".join(seen[i][-10:]))
        codes = {}
        for i, port in enumerate(ports):
            imgs = pool[8 * i:8 * i + 8]
            body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
            codes[f"classify {i}"], out = _http(port, "POST", "/classify", body)
            reply = json.loads(out)
            with tempfile.TemporaryDirectory(dir=workdir) as tmp:
                results.write_result_file(np.array([r["label"] for r in reply["results"]]),
                                          np.array([r["prob"] for r in reply["results"]]),
                                          f"{tmp}/served.txt")
                results.write_result_file(want[0][8 * i:8 * i + 8], want[1][8 * i:8 * i + 8],
                                          f"{tmp}/alone.txt")
                _line_rule(f"--multihost daemon {i}, POST /classify 8 images vs the one-card "
                           "engine", f"{tmp}/served.txt", f"{tmp}/alone.txt",
                           p32[8 * i:8 * i + 8])
            codes[f"reload {i}"], _ = _http(port, "POST", "/reload",
                                            json.dumps({"weights": f"{workdir}/params.npz"}))
        for p in procs:
            p.send_signal(signal.SIGTERM)
    except BaseException:
        _kill(procs)
        raise
    _finish(procs, MESH_SERVE_TIMEOUT, "--multihost process")
    log(f"--multihost (2 processes, explicit coordinator): daemons' codes {codes}; serve then "
        f"train in {time.perf_counter() - t0:.3f} s")
    if codes != {"classify 0": 200, "reload 0": 409, "classify 1": 200, "reload 1": 409}:
        raise RuntimeError(f"--multihost daemons: codes {codes}")
    outs = [json.load(open(f"{workdir}/mh{i}.out.json")) for i in range(RANKS)]
    with open(f"{workdir}/train_mh.jsonl") as fh:
        return outs, [json.loads(ln)["loss"] for ln in fh]


def phase_serve_mesh(dev: torch.device, card: str, workdir: str) -> dict:
    """Phase 49: serving over a mesh, two ranks sharing the card over gloo
    (``torchrun`` with a time limit, ``--rank-serve-mesh-worker``): the
    ``InferenceServer`` on tp 2 ``fused`` and ``quant`` and dp 2 ``fused``
    (64 requests of phase 39's stream) and fp32 tp 2 (8 requests), each
    answer against the one-card engine's classify of that request alone by
    the comparator rule (fp32: probabilities within 1e-4), the launches per
    rank per batch; the dp 2 ``LockstepServer`` (each rank its own
    requests; one idle second launches nothing; rank 1 stops while rank 0
    has 10 requests queued, all answered); the tp 2 daemon (POST /classify,
    /reload to seed 1); the serve CLI's ``--multihost`` daemons and the
    train CLI's ``--multihost`` on two explicit-coordinator processes, the
    latter's losses the ``--dp 2`` run's; img/s, p50 and p99 of each server
    beside the one-card server's on the same requests.  -> launch counts of
    rank 0 by path."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint, results
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.serving import InferenceServer

    params = synth_params(VIT_B_16, 0)
    checkpoint.save_npz(params, f"{workdir}/params.npz")
    checkpoint.save_npz(synth_params(VIT_B_16, 1), f"{workdir}/params_seed1.npz")
    pool = synth_images(SERVE_POOL, VIT_B_16, seed=2)
    np.save(f"{workdir}/pool.npy", pool)
    os.makedirs(f"{workdir}/shards")
    rng = np.random.default_rng(49)
    _write_shards(f"{workdir}/shards", synth_images(sum(DATA_SHARDS), VIT_B_16, seed=49),
                  rng.integers(0, VIT_B_16.num_classes, sum(DATA_SHARDS)))

    # the one-card references: every pool image alone, and the one-card server
    t_ref = time.perf_counter()
    stream = _serve_stream()[:MESH_SERVE_REQUESTS]
    one = {}
    for ops, dtype, count in (("fused", "float32", MESH_SERVE_FP32_REQUESTS),
                              ("fused", "bfloat16", MESH_SERVE_REQUESTS),
                              ("quant", "bfloat16", MESH_SERVE_TP_REQUESTS)):
        eng = InferenceEngine(VIT_B_16, params, dtype, ops, dev, batch_pad=SERVE_PAD)
        one[ops, dtype] = [eng.classify(pool[o:o + n]) for o, n in stream[:count]]
        if (ops, dtype) == ("fused", "float32"):
            p32_pool = eng.probabilities(pool).cpu().numpy()
            probs32 = [eng.probabilities(pool[o:o + n]).cpu().numpy()
                       for o, n in stream[:MESH_SERVE_FP32_REQUESTS]]
        if (ops, dtype) == ("fused", "bfloat16"):
            lock_want = {r: [eng.classify(pool[o:o + n]) for o, n in _lockstep_stream(r)]
                         for r in range(RANKS)}
            late_want = [eng.classify(pool[o:o + n]) for o, n in _lockstep_stream(0, late=True)]
            mh_want = eng.classify(pool[:8 * RANKS])
            daemon_want = eng.classify(pool[:8])
            server = InferenceServer(eng, max_batch=SERVE_MAX_BATCH,
                                     max_delay_ms=SERVE_DELAY_MS, max_queue_images=1 << 31)
            server.warmup()
            with server:
                t0 = time.perf_counter()
                futures = [server.submit(pool[o:o + n]) for o, n in stream]
                for f in futures:
                    f.result(timeout=SERVE_WAIT)
                wall = time.perf_counter() - t0
            one_card = _stats_line(server.stats, sum(n for _, n in stream), wall)
            del server
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    daemon_want1 = InferenceEngine(VIT_B_16, synth_params(VIT_B_16, 1), "bfloat16", "fused",
                                   dev, batch_pad=SERVE_PAD).classify(pool[:8])
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 49's inputs and one-card references: {time.perf_counter() - t_ref:.3f} s")

    _run_ranks("--rank-serve-mesh-worker", workdir, MESH_SERVE_TIMEOUT, "serving ranks")
    reports = [json.load(open(f"{workdir}/serve_rank{r}.json")) for r in range(RANKS)]
    answers = dict(np.load(f"{workdir}/serve_rank0.npz"))
    log("serving ranks, s a part (rank 0): " + ", ".join(
        f"{k} {v:.3f}" for k, v in reports[0]["section_s"].items()))

    def rule(what, labels, top, want, p32):
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            results.write_result_file(labels, top, f"{tmp}/served.txt")
            results.write_result_file(np.concatenate([w[0] for w in want]),
                                      np.concatenate([w[1] for w in want]), f"{tmp}/alone.txt")
            _line_rule(what, f"{tmp}/served.txt", f"{tmp}/alone.txt", p32)

    launches = {}
    for name, (axes, ops, dtype, count, per_batch) in MESH_SERVE_RUNS.items():
        runs = [rep["runs"][name] for rep in reports]
        lead = runs[0]
        forwards = lead["forwards"]  # warmup's padded sizes (32, 64) and the batches
        what = (f"{name} ({ops} {dtype} over {axes}, {count} requests, {lead['images']} images, "
                f"{lead['batches']} batches)")
        if forwards != lead["batches"] + 2 or any(r["forwards"] != forwards for r in runs):
            raise RuntimeError(f"{what}: forwards per rank {[r['forwards'] for r in runs]}, "
                               f"expected {lead['batches']} batches + 2 warmup sizes")
        for r, run in enumerate(runs):
            _expect_counts_of(run["launches"], {k: n * forwards for k, n in per_batch.items()},
                              f"rank {r} {what}, {forwards} forwards")
        launches[name] = lead["launches"]
        sub = stream[:count]
        p32 = np.concatenate([p32_pool[o:o + n] for o, n in sub])
        if dtype == "float32":
            got = answers[f"{name}/probs"]
            d = float(np.abs(got - np.concatenate(probs32)).max())
            log(f"{what}: probabilities vs the one-card fp32 engine's max|d|={d:.6g} (tol 1e-4)")
            if not d <= 1e-4:
                raise RuntimeError(f"{what}: probabilities outside 1e-4 of the one card's")
        rule(f"{what} vs the one-card engine alone", answers[f"{name}/labels"],
             answers[f"{name}/top"], one[ops, dtype][:count], p32)
        log(f"{name} server: {lead['img_s']:.6g} img/s, p50 {lead['p50_ms']:.6g} ms, p99 "
            f"{lead['p99_ms']:.6g} ms ({lead['images']} images in {lead['wall_s']:.6g} s), "
            f"{RANKS} ranks sharing one card over gloo (not a scaling figure); {card}")
    log(f"one-card server, the same {MESH_SERVE_REQUESTS} requests (bf16 fused): "
        f"{one_card['img_s']:.6g} img/s, p50 {one_card['p50_ms']:.6g} ms, p99 "
        f"{one_card['p99_ms']:.6g} ms ({one_card['batches']} batches); {card}")

    # the lockstep server
    for r, rep in enumerate(reports):
        idle = rep["lockstep_idle"]
        _expect_counts_of(idle["launches"], {},
                          f"rank {r} lockstep, {LOCKSTEP_IDLE_S} s with no traffic")
        if idle["forwards"]:
            raise RuntimeError(f"rank {r} lockstep: {idle['forwards']} forwards while idle")
        run = rep["runs"]["serve_lockstep"]
        _expect_counts_of(run["launches"], {k: n * run["forwards"] for k, n in
                                            LOCKSTEP_TICK.items()},
                          f"rank {r} serve_lockstep (dp 2, local_batch {LOCKSTEP_BATCH}, "
                          f"{run['forwards']} ticks)")
        mine = _lockstep_stream(r)
        got = dict(np.load(f"{workdir}/serve_rank{r}.npz"))
        rule(f"rank {r} lockstep, its {len(mine)} requests vs the one-card engine alone",
             got["lockstep/labels"], got["lockstep/top"], lock_want[r],
             np.concatenate([p32_pool[o:o + n] for o, n in mine]))
        log(f"rank {r} lockstep server: {run['img_s']:.6g} img/s, p50 {run['p50_ms']:.6g} ms, "
            f"p99 {run['p99_ms']:.6g} ms ({run['images']} images of its own, {run['batches']} "
            f"ticks with its rows), stop waited {run['stop_wait_s']:.6g} s; {RANKS} ranks "
            f"sharing one card over gloo (not a scaling figure); {card}")
    late = _lockstep_stream(0, late=True)
    rule(f"rank 0 lockstep, its {LOCKSTEP_LATE} requests queued when rank 1 stopped",
         answers["lockstep_late/labels"], answers["lockstep_late/top"], late_want,
         np.concatenate([p32_pool[o:o + n] for o, n in late]))
    launches["serve_lockstep"] = reports[0]["runs"]["serve_lockstep"]["launches"]

    # the tp 2 daemon
    run = reports[0]["runs"]["serve_http_tp"]
    codes = {k: run[f"{k}_code"] for k in ("classify", "reload", "classify_seed1")}
    log(f"tp 2 daemon: codes {codes}, stopped {run['stopped']}")
    if codes != {"classify": 200, "reload": 200, "classify_seed1": 200} or not run["stopped"]:
        raise RuntimeError(f"tp 2 daemon: codes {codes}, stopped {run['stopped']}")
    for step, want in (("classify", daemon_want), ("classify_seed1", daemon_want1)):
        rule(f"tp 2 daemon POST /{step}, 8 images vs the one-card seed-"
             f"{1 if step.endswith('1') else 0} engine", answers[f"daemon_{step}/labels"],
             answers[f"daemon_{step}/top"], [want], p32_pool[:8])
    for r, rep in enumerate(reports):
        run = rep["runs"]["serve_http_tp"]
        _expect_counts_of(run["launches"], {k: n * run["forwards"] for k, n in
                                            MESH_SERVE_RUNS["serve_tp"][4].items()},
                          f"rank {r} serve_http_tp ({run['forwards']} forwards: warmup and 2 "
                          "POSTs)")
    launches["serve_http_tp"] = reports[0]["runs"]["serve_http_tp"]["launches"]

    # --multihost: the serve CLI's daemons, then the train CLI against --dp 2
    outs, mh_losses = phase_multihost(workdir, pool, mh_want, p32_pool[:8 * RANKS])
    for i, (served, trained) in enumerate(outs):
        # warmup's tick, then the two classify ticks (each process joins both)
        _expect_counts_of(served["launches"], {k: 3 * n for k, n in LOCKSTEP_TICK.items()},
                          f"--multihost daemon {i} (warmup + 2 ticks of {MULTIHOST_LOCAL_BATCH})")
        _expect_cli(trained["launches"], MULTIHOST_TRAIN, MULTIHOST_STEPS,
                    f"--multihost train process {i} (depth 2, {MULTIHOST_STEPS} steps)")
    launches["serve_multihost"] = outs[0][0]["launches"]
    for r, rep in enumerate(reports):
        run = rep["runs"]["train_dp_depth2"]
        if run["rc"] != 0:
            raise RuntimeError(f"rank {r} train --dp 2: exited {run['rc']}")
        _expect_cli(run["launches"], MULTIHOST_TRAIN, MULTIHOST_STEPS,
                    f"rank {r} train --dp 2 (depth 2, {MULTIHOST_STEPS} steps)")
    with open(f"{workdir}/train_dp.jsonl") as fh:
        dp_losses = [json.loads(ln)["loss"] for ln in fh]
    log(f"train --multihost (2 processes, explicit coordinator) losses {mh_losses}; --dp 2 "
        f"torchrun {dp_losses}")
    if mh_losses != dp_losses or len(dp_losses) != MULTIHOST_STEPS:
        raise RuntimeError("train --multihost: its losses differ from the --dp 2 run's")
    launches["train_multihost"] = outs[0][1]["launches"]
    return launches


def group_serve_mesh(dev, card, summary, launches) -> None:
    """Phase 49."""
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        launches.update(phase_serve_mesh(dev, card, workdir))


PHASES = ("classify", "train", "regularized", "long", "quant", "tome", "dh80", "per_op", "adamw",
          "parallel", "serve", "mae", "distill", "qat", "data", "recipe", "pp_sp", "serve_mesh")


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
    p.add_argument("--rank-train-worker", metavar="DIR",
                   help="run one rank of phase 45 (torchrun starts these), writing into DIR")
    p.add_argument("--rank-recipe-worker", metavar="DIR",
                   help="run one rank of phase 47 (torchrun starts these), writing into DIR")
    p.add_argument("--rank-pp-sp-worker", metavar="DIR",
                   help="run one rank of phase 48 (torchrun starts these), writing into DIR")
    p.add_argument("--rank-serve-mesh-worker", metavar="DIR",
                   help="run one rank of phase 49 (torchrun starts these), writing into DIR")
    p.add_argument("--cli-worker", metavar="SPEC",
                   help="run one of phase 49's explicit-coordinator CLI processes (SPEC.json)")
    args = p.parse_args(argv)
    if args.rank_worker:
        rank_worker(args.rank_worker)
        return
    if args.rank_train_worker:
        train_rank_worker(args.rank_train_worker)
        return
    if args.rank_recipe_worker:
        recipe_rank_worker(args.rank_recipe_worker)
        return
    if args.rank_pp_sp_worker:
        pp_sp_rank_worker(args.rank_pp_sp_worker)
        return
    if args.rank_serve_mesh_worker:
        serve_mesh_rank_worker(args.rank_serve_mesh_worker)
        return
    if args.cli_worker:
        cli_worker(args.cli_worker)
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
              "serve": group_serve, "mae": group_mae, "distill": group_distill, "qat": group_qat,
              "data": group_data, "recipe": group_recipe, "pp_sp": group_pp_sp,
              "serve_mesh": group_serve_mesh}
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
    # K18a and K18b, the kernel study's for K19, rank 0's of the bf16 --tp 2
    # train CLI for K8 residual=False; "paths" has every reading
    path_of = {**{k: "classify" for k in KERNELS}, **{k: "train" for k in TRAIN_KERNELS},
               **{k: "train_regularized" for k in REG_KERNELS},
               **{k: "train_long" for k in LONG_KERNELS}, "flash_attention_fwd": "classify_long",
               **{k: "classify_quant" for k in QUANT_KERNELS}, "ln_qkv_q8": "classify_quant_long",
               "ln_mlp_residual_q8": "classify_quant_tome",
               **{k: "train_tome_regularized" for k in TOME_KERNELS},
               **{k: "classify_per_op" for k in PER_OP_KERNELS},
               **{k: "train_fused_adamw" for k in ADAMW_KERNELS},
               **{k: "classify_quant_tp" for k in TP_KERNELS},
               **{k: "kernel_study" for k in STUDY_KERNELS},
               **{k: "train_tp" for k in K8_PARTIAL_KERNELS}}
    all_kernels = {**KERNELS, **TRAIN_KERNELS, **REG_KERNELS, **LONG_KERNELS, **QUANT_KERNELS,
                   **TOME_KERNELS, **PER_OP_KERNELS, **ADAMW_KERNELS, **TP_KERNELS,
                   **STUDY_KERNELS, **K8_PARTIAL_KERNELS}
    # K8's tensor-parallel form counts as K8 (its wrapper's count), on the
    # tensor-parallel train paths only, where K8 runs in no other form
    counter = {name: "ln_mlp_residual_bwd" if name in K8_PARTIAL_KERNELS else name
               for name in all_kernels}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches.get(path_of[name], {}).get(counter[name]),
         "paths": {path: counts[counter[name]] for path, counts in launches.items()
                   if name not in K8_PARTIAL_KERNELS or path.startswith("train_tp")},
         **summary[name]}
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
