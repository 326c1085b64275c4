#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``neuralsvb_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and the CUDA toolkit (nvcc); without them it raises and exits non-zero.
Every phase prints one JSON line; any failure raises.

1. environment: torch / CUDA versions, the card, its power limit;
2. build, all at once: nvcc builds ``neuralsvb_torch/csrc/resblock_bf16.cu``,
   ``csrc/fused_resblock.cu``, ``csrc/dilated_conv_backward.cu``,
   ``csrc/amp_activation.cu``, ``csrc/mrd_conv_backward.cu`` and
   ``csrc/chi2_dist.cu`` for sm_90a, g++ the
   port's host DTW/Viterbi library (``neuralsvb_torch/csrc/dtw.cpp``);
   ptxas's lines are printed;
3. kernel vs plain, TF32 off for every plain reference. The bf16
   ResBlock-cluster kernel (tensor cores; the main path's) against the plain
   version with bf16 operands at the flagship vocoder's stage shapes for
   1024 mel frames, for the main path's 2048-frame bucket and for the
   vocoder training path's 16 crops of 64 frames, a ragged length and B=2:
   max|d| <= 1e-3 * max(1, max|ref|) and mean|d| <=
   0.5 * mean|plain_bf16 - plain_f32| (the bf16 pipeline's rounding flips
   under another f32 summation order stay below that; f32 operands sit at
   about 1.0); median times over 20 runs from CUDA events of the kernel,
   plain f32, plain TF32 and cuDNN on bf16 tensors. The f32 kernel against
   the plain f32 version at the 1024-frame shapes, the ragged length and
   B=2, max|d| <= 1e-4 * max(1, max|ref|), and the autograd path's
   gradients (bf16 kernel forward, f32 backward kernels) against the plain
   f32 path at 1e-4 and against float64 (the worst tensor's relative L2
   error within BWD_ERR_RATIO times the plain f32 path's), bit-equal over
   two calls, 54 backward launches. The cluster backward's kernels
   (``phase_cluster_backward``) at the vocoder training stage shapes and
   [1, 64, 704]: against the plain twin and float64 as above, bit-equal,
   launches per stage, device times beside the f32 least time and the
   plain recompute + autograd's (``--cluster-backward`` runs the build,
   the autograd check and this phase alone). BigVGAN's fused anti-aliased
   SnakeBeta (``phase_amp``, ``csrc/amp_activation.cu``) at the six stage
   shapes of the ``bigvgan_train`` cell (4 crops of 256 frames, 768 ... 24
   channels): forward and backward kernels against their plain twins
   within 1e-4 of max(1, max|ref|) and, with the plain f32 path, against
   float64 (the worst tensor within 1.5 times the plain path's), two
   backward calls bit-equal, 1 + 2 launches, device times beside the
   bound and the plain path's (``--amp`` runs the build, this phase and
   phase 4's BigVGAN training alone). The AMP towers' convolution backward
   (``phase_amp_conv_backward``, the plain instances of
   ``csrc/dilated_conv_backward.cu``) at the same
   stage shapes, K 3/7/11 at dilations 1, 3, 5: dx, dW and db against the
   plain twin within 1e-4 and, with the plain f32 path, against float64
   (the worst tensor within 3 times the plain path's), bit-equal over two
   calls, device times by kernel beside the step's least time and the
   plain path's (``--amp-conv-bwd`` runs the build, this phase and phase
   4's BigVGAN training alone). BigVGAN's MRD convolution backward
   (``phase_mrd_conv_backward``, ``csrc/mrd_conv_backward.cu``) at the
   cell's 18 layer shapes: dx, dW and db from cuDNN's forward against the
   plain twin within 1e-4 and against float64 (each tensor within 3 times
   the plain f32 path's error of that tensor), bit-equal over two calls,
   device times of a step's three calls a layer (the discriminators' two,
   the generator's one) by kernel beside the least time and cuDNN's
   autograd (``--mrd-conv-bwd`` runs the builds, this phase
   and phase 4's BigVGAN training alone). Then the chi-square DTW cost
   kernel against its plain version at (S, T) = (2400, 2400), (1037,
   1301), (130, 70), (1, 1), M = 48, on
   EHSADTW histograms of vibrato f0 and on random rows with all-zero rows,
   max|d| <= 1e-5; on those rows with values outside the kernel's
   branch-free division range (1e-30, 1e8, negative) in bins 16-31 of some
   rows, so that a tile mixes both divisions, max|d| / max(1, |ref|) <=
   1e-5; on every kind ``chi2_dist(b, a)`` equal to ``chi2_dist(a, b).T``
   bit for bit; per shape the per-call time (``kernel_ms``, median of 20
   event-timed calls, host issue included), the device time (``device_ms``,
   100 calls between two events, over 100), the roofline bound
   (``bound_us``: 7 operations per term at 66.9 TFLOP/s f32 or the bytes at
   3.35 TB/s, the larger) and the issue bound (``issue_bound_us``: the
   SASS instructions per term of the kernel's division loop, counted from
   ``cuobjdump -sass``, over 4 warp-instructions per clock on each SM at
   the card's top SM clock), with the device time's share of each;
4. main path: ``python -m neuralsvb_torch.tasks.run --infer`` on a synthetic
   4-utterance packed test split (6-10 s each) at the flagship widths
   (SVBVAE hidden 256 / latent 128 / FVAE 192 k5 8+4, 2-layer conformer
   ASR; HiFiGAN-NSF 512 channels, rates 8,8,2) with seeded random weights;
   it must write 4 x 5 wavs of length frames x 128 that are finite and not
   silent, and launch the bf16 kernel 18 x 3 stages x 20 vocoder calls
   times (its operand pre-pass 3 x 20). Then BigVGAN-v2's main path,
   ``python -m neuralsvb_torch.tasks.run`` on its recipe at the published
   widths and per-card batch (1536 channels, six stages, 4 x 65536
   samples) on a synthetic 24 kHz split, seeded weights, 3 steps of the
   generator, MPD and MRD and 2 validations of 2 items: losses finite with
   their keys; from the summary, 109 forward AMP launches per generator
   call (training and validation) and 218 backward per step, 108 tower and
   54 MRD convolution backwards per step, none of the HiFiGAN cluster's
   (``phase_bigvgan_train``);
5. card vs CPU: one utterance at zero noise through the port's slice on the
   card (kernels) and on the CPU (plain versions, which the CPU tests hold
   to the JAX package), in both mm dtypes, TF32 off. f32 (the f32 kernel's
   path, 18 x 3 launches): mel_out and wav within 1e-3. bf16 (18 x 3
   launches of the bf16 kernel): mel_out within 1e-3, wav within 2e-3, and
   mean|card - cpu_bf16| <= 0.8 * mean|cpu_bf16 - cpu_f32| (rounding flips
   compound through the 54 bf16 convs: two f32 summation orders of the same
   bf16 vocoder sit about 0.6 of that gap apart, f32 operands at 1.0);
6. binarize path: 8 synthetic amateur/professional pairs of sung vibrato
   (2 singers x 2 songs x 2 pieces, amateur 6-14 s, professional 5-15%
   longer or shorter, one singer the test split) through both passes of the
   flagship's binarize recipe, ``python -m neuralsvb_torch.data.binarize``
   with ``save_emb_torch.yaml`` then ``para_bin_torch.yaml`` on the card
   (seeded GE2E weights). Every item must carry the packed keys, with an
   in-range monotone ``a2p_f0_alignment``; the chi-square kernel must launch
   once per paired item; the port's ``MultiSpkEmbDataset`` must collate the
   test split;
7. binarize, card vs CPU: the test split again on the CPU: mel within 1e-4,
   f0 within 1 Hz and the alignment equal on >= 99% of frames, the DTW's
   total path cost over the card's and the CPU's cost within 1e-4 relative,
   the item's own speaker embedding within 1e-4;
8. train: ``python -m neuralsvb_torch.tasks.run`` trains the flagship at full
   width on phase 6's packed splits (the Female1 pairs train, the Male6
   pairs validate and test), seeded weights, ``phase_2_steps`` 4 and
   ``max_updates`` 8, validating (and vocoding the first validation batch)
   at steps 0, 4 and 8; then resumes to step 10; then ``--infer`` renders
   the test split from the trained checkpoint. Every logged loss is finite
   and each phase logs its keys; the frozen ASR never changes, the latent
   map does not change in phase 2 and is the only part of the model that
   changes in phase 3; validation wavs are written; the bf16 ResBlock
   kernel launches 18 x 3 stages per vocoder call of validation; the resumed
   run starts at step 8; the wav tree has 5 wavs per test utterance. It
   prints ``| train summary:`` (steps, device-synchronized seconds per step
   by phase, peak memory, launches);
9. train, card vs CPU: one generator + discriminator step and one latent-map
   step of the same seeded full-width model on the same batch (the four
   train items cropped to 640 frames), at zero noise, pinned discriminator
   windows and the same dropout masks (drawn on the CPU), TF32 off; on the
   card and on the CPU, in float32 (the training path) and in float64 (the
   same weights). Losses within 1e-4 relative in both. Gradients, per
   tensor, card against CPU in float64 within 1e-3 of the tensor's scale
   (max(max|g|, 1e-3 of the optimizer group's largest)). In float32 the
   same differences are printed, beside each side's error against float64:
   the latent map's float32 gradient is ill-conditioned in itself (its few
   parameters take a whole batch's decoder Jacobian through a
   training-mode BatchNorm over the batch alone), and two correct float32
   runs differ there by percents of its scale;
10. vocoder train: the pairs of phase 6 binarized again with
   ``vocoder_bin_torch.yaml`` (waveforms kept; the χ² kernel launches once
   per item), then ``python -m neuralsvb_torch.tasks.run --config
   hifigan_nsf_torch.yaml`` trains the recipe's vocoder at full width (512
   channels, rates 8,8,2, ResBlock1 3/7/11 x (1,3,5), crops of 8192
   samples; the 4 Female1 items train, the 4 Male6 items validate) from
   seeded weights for 4 steps, the discriminators from step 2, validating
   at 0 and 4, then resumes to 6. Every logged loss is finite with the
   keys of its step, the generator and both discriminators change, and the
   bf16 ResBlock kernel launches exactly 54 convs + 3 pre-passes per
   generator call (each training step and each validation batch). Then the
   SVB ``--infer`` of phase 8 renders the test split through the trained
   vocoder (``vocoder_ckpt`` = its work dir): it must print the load line
   and write 20 wavs that are not silent. In this process, warm generator
   + discriminator steps at the recipe's batch (16 x 8192, synthetic
   crops): first step, median/min/max, peak memory, launches per step
   (54 + 3, checked), a ``torch.profiler`` split by kernel kind and the
   device times of the cluster forward (phase 3's training rows), the
   cluster backward's kernels (and the plain f32 recompute + autograd they
   replaced), the discriminators and the log-mel L1, each alone;
11. vocoder train, card vs CPU: see ``phase_vocoder_card_vs_cpu``: in f32
   losses within 1e-4 relative, gradients within 1e-3 in relative L2 (the
   discriminators' also per tensor); with bf16 operands each loss within
   the bf16-vs-f32 gap of the CPU;
12. variants: the two technique-prior recipes (``vae_tech_mle_eng_torch.yaml``,
   ``vae_seg_tech_mle_eng_torch.yaml``) at the flagship's full width on
   phase 6's splits, seeded weights, ``phase_2_steps`` 2: train steps 0-2
   (validating and vocoding the first validation batch at 0), resume for
   step 3 (the latent map; validating at 4), then ``--infer`` the test
   split. Every logged loss is finite with its phase's keys (the map step
   has no ``a2p_mle``, as in the JAX package); the frozen ASR never
   changes, the latent map is the only part that changes in phase 3 (the
   seg attention trains in phase 2); 20 wavs, none silent; the bf16
   ResBlock kernel launches exactly 54 convs + 3 pre-passes per vocoder
   call in every process. Prints each recipe's synchronized step seconds
   by phase and peak memory;
13. variants, card vs CPU, TF32 off: each other variant's seeded model
   (``local`` at latent 16) forward on one test utterance at zero noise:
   ``mel_out`` and the sampled a2p decode within 1e-3, ``kl``/``mle``
   within 1e-4 relative, the seg attention weights within 1e-5; one gen +
   disc and one map step of the seg task in float64 at phase 9's gates;
14. PWG: ``python -m neuralsvb_torch.tasks.run --config pwg_torch.yaml``
   trains the Parallel WaveGAN recipe at full width (30 layers, 64/128/64
   channels, 5 crops of 25600 samples) on phase 10's split, seeded weights:
   the split is hop 128, so the upsample scales are 4,4,4,2 and the context
   window 0 in both the task's and the vocoder loader's keys. 8 steps with
   the discriminator from step 3 (``disc_start_steps`` 2), validating at 0,
   3 and 6, then a resume to 10, so that both RAdam optimizers take their
   rectified steps (from their sixth) on the card. Every logged loss is
   finite with JAX's keys (``sc``, ``mag``, ``a``; ``r``, ``f``), the
   discriminator is unchanged in the step-3 checkpoint and changed by the
   step-6 one, no kernel of the repo launches. Then phase 8's ``--infer``
   with ``vocoder=PWG`` and ``vocoder_ckpt`` the PWG work dir: 20 wavs of
   frames x 128 samples, none silent. In this process, warm generator +
   discriminator steps at the recipe's own shapes (5 x 25600 samples,
   scales 4,4,4,4, hop 256): first step, median/min/max, peak memory and a
   ``torch.profiler`` split by kernel kind; then one gen + disc step of the
   hop-128 model on two crops of 12800 samples in float64, card vs CPU,
   at phase 9's gates;
15. a JAX-format checkpoint: seeded full-width HiFiGAN-NSF weights written
   as a flax ``params.msgpack`` (the encoder and the JAX tree layout live
   here; a CPU test holds them to flax) and as a port checkpoint; each
   loaded by ``vocoders/hifigan.py`` vocodes a 2000-frame mel (the 2048
   bucket) at zero noise through the bf16 ResBlock kernel: bit-identical
   wavs, 18 x 3 conv launches and 3 pre-passes for the JAX-format one,
   and the file decodes to the written tree exactly;
16. ASR pre-training, binarize: 2 speakers x 24 utterances of 2-6 s of a
   voiced harmonic tone (22050 Hz) with an English sentence each in a
   ``text_labels/`` mirror, through ``python -m
   neuralsvb_torch.data.binarize --config vc_ppg_torch.yaml`` on the card
   (``test_num`` 4): 44/4/4 items, each with phone tokens that spell its
   ``ph`` through ``phone_set.json``, mostly voiced f0, a transcript; the
   item counts and the phone-set size are printed;
17. ASR pre-training, train: ``python -m neuralsvb_torch.tasks.run --config
   vc_ppg_torch.yaml`` at the recipe's full width (hidden 256, conformer ASR
   2 + 2 layers, 4 conv decoder layers, discriminator 3 windows x 128) from
   seeded weights, 4 steps with the discriminator from step 1, validating
   at 0, 2 and 4, then a resume to 6. Every logged loss is finite with
   JAX's keys (``l1``, ``ssim``, ``asr``, ``a``; ``r``, ``f``); the ASR's
   encoder and decoder head change while its BatchNorm statistics do not;
   the mel decoder and the discriminator change; no kernel of the repo
   launches (this path computes nothing in Pallas in the JAX package);
18. ASR pre-training, step time: ``scripts/train_profile.py --config
   vc_ppg_torch.yaml``, warm generator + discriminator steps at the
   recipe's token budget (40 x 750 frames, synthetic) in float32 without
   TF32: first step, median/min/max, peak memory and a ``torch.profiler``
   split by kernel kind with the busy share;
19. ASR pre-training, card vs CPU: see ``phase_vcppg_card_vs_cpu``;
20. warm start: the flagship recipe with ``pretrain_asr_ckpt`` at phase
   17's work dir trains one step on phase 6's splits; its frozen ASR equals
   the pre-training checkpoint's bit for bit (the decoder head's tensors
   skipped) and its step-0 validation vocodes through HiFiGAN-NSF with 54 +
   3 bf16 launches per vocoder call;
21. bf16 step time: ``scripts/train_profile.py --variant f32: --variant
   bf16:compute_dtype=bfloat16`` on the flagship at B = 4 x 2560 frames:
   warm phase-2 and phase-3 medians, peak memory and the profiled split of
   each, side by side;
22. bf16 card vs CPU: phase 9's steps with ``compute_dtype: bfloat16`` on
   the card against phase 9's CPU float64 run (``phase_bf16_card_vs_cpu``:
   losses, gradients in L2 and the update's sign, at the bounds
   ``BF16_*``; the map step also from the float64 run's parameters, and
   every BatchNorm call against float64 on its own input);
23. accumulation: ``accumulate_grad_batches: 2`` in float64, card vs CPU;
   parameters move only at even micro-steps (``phase_accum_card_vs_cpu``);
24. the bf16 vocoder: one ``vocoder_compute_dtype: bfloat16`` call beside
   the float32 one (wav bound, 54 + 3 launches, times);
25. data parallelism on the one card, two ranks over gloo on cuda:0:
   spawned ranks against one process in float64, then ``torchrun
   --nproc_per_node 2`` through the training CLI with multi-directory
   training, ``cache_ppg``, ``use_cond_disc`` and accumulation, a
   validation and a resume (``phase_data_parallel``);
26. FS2 binarize: 2 speakers x 12 utterances of 2-6 s with transcripts and
   MFA TextGrids through ``python -m neuralsvb_torch.data.binarize --config
   fs2_adv_torch.yaml`` (``with_f0cwt`` on): 20/4/4 items with ``mel2ph``,
   ``ph2word`` and the f0's CWT;
27. FS2 train: ``fs2_adv_torch.yaml`` at the recipe's full width (hidden
   256, 4 FFT encoder and 4 conv decoder layers, 2 heads, the multi-window
   discriminator) from seeded weights, 4 steps with the discriminator from
   step 1, validating at 0, 2 and 4, then a resume to 6: every logged loss
   finite with JAX's keys, encoder, decoder, predictors and discriminator
   changed, no kernel launched. Then ``--infer`` twice: with the recipe's
   PWG (phase 14's hop-128 model; every count 0) and with HiFiGAN-NSF
   (``vocoder_keys``; 54 + 3 bf16 launches per call, a P and a G call per
   test item); each writes P and G wavs of frames x 128 samples, the mels
   and the f0 tracks;
28. FS2 step time: ``scripts/train_profile.py --config fs2_adv_torch.yaml``
   at the recipe's budget (30 x 1000 frames, 85 tokens each);
29. FS2 card vs CPU: the recipe's step, and two steps with ``pitch_type:
   cwt`` and ``cwt_add_f0_loss``, in float32 and float64 (phase 19's
   gates);
30. pitch alignment: ``python -m neuralsvb_torch.tasks.pitch_alignment_task``
   over phase 6's test split with the six aligners on the card and on the
   CPU: one χ² launch per item for SADTW and EHSADTW, the host aligners'
   accuracies equal, the two χ² aligners' differences reported;
31. MCD: phase 4's ``--infer`` on one utterance at zero noise on the card
   and on the CPU, ``python -m neuralsvb_torch.tasks.mcd_eval`` between the
   a2p mels, gated at 0.1 dB;
32. the SVBPara family at ``vc_ppg_torch.yaml``'s full width on phase 6's
   para splits, the pretrained tasks warm-started from phase 17: each of
   the six subclasses and ``SVBParaTask`` with ``ref_attn`` and with the
   conv ASR takes two generator + discriminator steps in this process
   (finite losses with the task's keys, every discriminator changed, the
   frozen ASR phase 17's bit for bit); then the CLI trains
   ``ParaPPGSpkConsistentTask`` 4 steps, resumes to 6 and ``--infer``s the
   test split through HiFiGAN-NSF (every way per item, frames x 128, not
   silent, 54 + 3 bf16 launches per vocoder call);
33. SVBPara card vs CPU: one step of each of phase 32's eight
   configurations, float64 gated as phase 9, float32 printed;
34. serving leftovers: ``shard_infer`` (the flagship's ``--infer`` on
   phase 8's checkpoint over two torchrun ranks on the card, a ragged last
   batch, against one process: mels within 1e-4, the same wav tree, each
   rank's launches per vocoder call) and the vocoder denoiser (card vs CPU
   at phase 5's bf16 gates, 54 + 3 launches);
35. the last modules (``phase_last_modules``): the profiling module
   (``neuralsvb_torch/utils/profiling.py``) on one vocoder call at the
   2048 bucket, merged busy beside summed, ``op_flops`` of the plain
   cluster against ``cluster_work`` (5%), its ``roofline`` equal to phase
   3's bound; the pulse and cyclic-noise NSF sources card vs CPU (1e-5);
   whether ``matplotlib`` and ``ffmpeg`` are installed, and the figures and
   mp3 input behaving accordingly.

The timing helpers, peak rates and roofline, profiler splits and the χ²
issue bound's SASS count come from ``neuralsvb_torch/utils/profiling.py``;
the synthetic crops and χ² inputs from ``neuralsvb_torch/data/synthetic.py``.
Two studies of the smoke's own phases run on request, not in the smoke:
``python3 chip_smoke.py --bf16-map-spread`` (phase 22's gate over seeds and
planted faults) and ``python3 chip_smoke.py --binarize-ab --other DIR``
(phase 6's para pass against another checkout).

The line before the last is the kernel table: per kernel its launches on
the main path (the bf16 ResBlock kernel's also on the training path's
validation, ``train_launches``, on the vocoder's training path,
``vocoder_train_launches``, with its times at that path's shapes, and on
the technique-prior recipes' training and ``--infer`` processes,
``variants_train_launches`` and ``variants_infer_launches``, and on phase
15's JAX-format vocoder call, ``jax_checkpoint_launches``, and on
phase 20's warm-started flagship, ``vcppg_warm_start_launches``, on
phase 24's bf16 vocoder call, ``bf16_vocoder_launches``, on phase
25's rank 0 under torchrun, ``data_parallel_train_launches``, and on phase
27's HiFiGAN ``--infer`` of FS2, ``fs2_infer_launches``, on phase 32's
``--infer``, ``svb_para_infer_launches``, on each rank of phase 34's
sharded ``--infer``, ``shard_infer_launches``, and on its denoised call,
``denoise_launches``, and on phase 35's profiled vocoder call,
``profiled_call_launches``; the χ² kernel's
also in the vocoder's binarize pass and in phase 30's harness,
``harness_launches``), worst error, time per call (``ms``; for the
χ² kernel also ``device_ms``), plain time and bound (``bound_ms``,
``bound_by``) at the main path's shapes; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
WORK = os.path.join(REPO, "build", "chip_smoke")
UTT_FRAMES = (1040, 1300, 1560, 1780)  # 6.0 - 10.3 s at hop 128, 22050 Hz
STAGE_SHAPES = ((1, 256, 8192), (1, 128, 65536), (1, 64, 131072))  # T_mel 1024
# the main path pads every utterance (1040-1780 frames) to the 2048 bucket
BUCKET_SHAPES = ((1, 256, 16384), (1, 128, 131072), (1, 64, 262144))
EXTRA_SHAPES = ((1, 256, 8000), (2, 128, 16384))  # ragged T, B = 2
# vocoder training: max_sentences 16 crops of max_samples 8192 (T_mel 64)
TRAIN_SHAPES = ((16, 256, 512), (16, 128, 4096), (16, 64, 8192))
BWD_SHAPES = TRAIN_SHAPES + ((1, 64, 704),)  # the cluster backward's phase
BWD_ERR_RATIO = 2.0  # backward kernels' error vs float64 over the plain f32 path's
BF16_MEAN_RATIO = 0.5  # phase 3: mean|kernel - plain_bf16| / mean|plain_bf16 - plain_f32|
WAV_MEAN_RATIO = 0.8   # phase 5: mean|card - cpu_bf16| / mean|cpu_bf16 - cpu_f32|
TPU_KERNEL = "neuralsvb_tpu/ops/fused_resblock.py:82"
CHI2_SHAPES = ((2400, 2400), (1037, 1301), (130, 70), (1, 1))  # (S, T), M = 48
CHI2_TPU_KERNEL = "neuralsvb_tpu/ops/pallas_kernels.py:33"
BOUND_BY = {"compute": "operations", "bandwidth": "bytes"}  # roofline's -> the line's
CHI2_OPS_PER_TERM = 7  # sub, mul, mul, add, add, div, accumulate
# binarize: (singer, song, base Hz); 2 pieces per song; Male6 is the test split
SONGS = (("Female1", "SongA", 220.0), ("Female1", "SongB", 262.0),
         ("Male6", "SongC", 147.0), ("Male6", "SongD", 165.0))
AMATEUR_SECONDS = (6.0, 14.0, 7.2, 12.6, 8.4, 11.4, 9.6, 13.2)
PROF_FACTOR = (1.05, 0.95, 1.15, 0.85, 1.10, 0.90, 1.08, 0.92)
PAIR_KEYS = ("mel", "prof_mel", "f0", "prof_f0", "pitch", "prof_pitch",
             "a2p_f0_alignment", "multi_spk_emb")
SR = 22050


def emit(phase, **kw):
    """One JSON line per phase; ``t_s``: seconds since the run started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0, **kw}), flush=True)


def tf32(on):
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def cluster_work(B, C, T, spec, weight_bytes):
    """(FLOP, bytes) of one stage's cluster: f32 x read, f32 mean written,
    the 18 convs' weights and biases read once."""
    taps = sum(2 * k * len(d) for k, d in spec)
    convs = sum(2 * len(d) for _, d in spec)
    return 2 * B * T * C * C * taps, 8 * B * C * T + weight_bytes * C * C * taps + 4 * C * convs


def random_cluster(C, spec, gen, device):
    """Packed cluster weights at default-conv scale, from ``gen``."""
    import torch
    ws = []
    for k, dils in spec:
        n, s = len(dils), (C * k) ** -0.5
        ws += [torch.randn(n, C, k, C, generator=gen) * s,
               torch.randn(n, C, generator=gen) * s,
               torch.randn(n, C, k, C, generator=gen) * s,
               torch.randn(n, C, generator=gen) * s]
    return [w.to(device) for w in ws]


def phase_kernel(fr, spec):
    """Both ResBlock kernels against the plain version; returns (bf16 rows,
    f32 rows, worst bf16 error, worst f32 error)."""
    import torch
    from neuralsvb_torch.utils.profiling import median_ms, roofline
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    rows16, rows32, worst16, worst32 = [], [], 0.0, 0.0
    for B, C, T in STAGE_SHAPES + BUCKET_SHAPES + EXTRA_SHAPES + TRAIN_SHAPES:
        x = torch.randn(B, C, T, generator=gen).cuda()
        w = random_cluster(C, spec, gen, "cuda")
        w16 = [t.to(bf16) if t.dim() == 4 else t for t in w]  # as the generator packs
        flop, nbytes = cluster_work(B, C, T, spec, 2)
        with torch.no_grad():
            tf32(False)
            ref32 = fr.resblock_cluster_plain(x, w, spec)
            ref16 = fr.resblock_cluster_plain(x, w, spec, bf16)
            out = fr.fused_resblock_cluster(x, w16, spec, bf16)
            torch.cuda.synchronize()
            d = (out - ref16).abs()
            err, mean_err = float(d.max()), float(d.mean())
            gap = float((ref16 - ref32).abs().mean())
            scale = max(1.0, float(ref16.abs().max()))
            ok = (err <= 1e-3 * scale and mean_err <= BF16_MEAN_RATIO * gap
                  and bool(torch.isfinite(out).all()))
            kernel_ms = median_ms(lambda: fr.fused_resblock_cluster(x, w16, spec, bf16))
            plain_ms = median_ms(lambda: fr.resblock_cluster_plain(x, w, spec))
            xb = x.to(bf16)
            cudnn_bf16_ms = median_ms(lambda: fr.resblock_cluster_plain(xb, w16, spec))
            tf32(True)
            plain_tf32_ms = median_ms(lambda: fr.resblock_cluster_plain(x, w, spec))
            tf32(False)
        bound, _, which = roofline(flop, nbytes, kernel_ms / 1e3, bf16)
        bound, bound_by = bound * 1e3, BOUND_BY[which]
        row = dict(B=B, C=C, T=T, max_abs_err=err, tol=1e-3 * scale, mean_abs_err=mean_err,
                   mean_bf16_f32_gap=gap, mean_ratio=mean_err / gap,
                   mean_ratio_tol=BF16_MEAN_RATIO, ok=ok, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, plain_tf32_ms=plain_tf32_ms,
                   cudnn_bf16_ms=cudnn_bf16_ms, kernel_tflops=flop / kernel_ms / 1e9,
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes)
        emit("bf16_kernel_vs_plain", **row)
        if not ok:
            raise AssertionError(f"bf16 kernel disagrees with plain: {row}")
        rows16.append(row)
        worst16 = max(worst16, err)
        if (B, C, T) in STAGE_SHAPES + EXTRA_SHAPES:  # the f32 kernel's rows
            with torch.no_grad():
                out = fr.fused_resblock_cluster(x, w, spec, torch.float32)
                torch.cuda.synchronize()
                err = float((out - ref32).abs().max())
                scale = max(1.0, float(ref32.abs().max()))
                ok = err <= 1e-4 * scale and bool(torch.isfinite(out).all())
                f32_ms = median_ms(lambda: fr.fused_resblock_cluster(x, w, spec, torch.float32))
            _, nbytes = cluster_work(B, C, T, spec, 4)
            bound, _, which = roofline(flop, nbytes, f32_ms / 1e3, torch.float32)
            bound, bound_by = bound * 1e3, BOUND_BY[which]
            row = dict(B=B, C=C, T=T, max_abs_err=err, tol=1e-4 * scale, ok=ok,
                       kernel_ms=f32_ms, plain_ms=plain_ms, plain_tf32_ms=plain_tf32_ms,
                       kernel_tflops=flop / f32_ms / 1e9, bound_ms=bound, bound_by=bound_by,
                       bytes=nbytes)
            emit("kernel_vs_plain", **row)
            if not ok:
                raise AssertionError(f"f32 kernel disagrees with plain: {row}")
            rows32.append(row)
            worst32 = max(worst32, err)
        del x, w, w16, xb, ref32, ref16, out
    phase_autograd(fr, spec, gen)
    return rows16, rows32, worst16, worst32


def autograd_grads(fn, x, w, g):
    """dL/dx and every weight's gradient of ``sum(fn(x, w) * g)``."""
    import torch
    x = x.detach().clone().requires_grad_(True)
    w = [t.detach().clone().requires_grad_(True) for t in w]
    return list(torch.autograd.grad((fn(x, w) * g).sum(), [x] + w))


def grad_errors(got, ref):
    """Each gradient's relative L2 distance from its float64 reference."""
    return [float((a.double() - b).norm() / b.norm()) for a, b in zip(got, ref)]


def phase_autograd(fr, spec, gen):
    """Gradients through the op's autograd path (bf16 kernel forward, the
    backward kernels) at [1, 64, 704]: against the plain f32 path (autograd
    through ``resblock_cluster_plain``) within 1e-4 of each tensor's scale;
    against float64, the worst tensor's relative L2 error within
    BWD_ERR_RATIO times the plain f32 path's worst; two calls bit-equal;
    the backward's launches."""
    import torch
    x = torch.randn(1, 64, 704, generator=gen).cuda()
    w = random_cluster(64, spec, gen, "cuda")
    g = torch.randn(1, 64, 704, generator=gen).cuda()
    before = fr.resblock_cluster_backward_cuda.launches
    got = autograd_grads(lambda a, b: fr.fused_resblock_cluster(a, b, spec), x, w, g)
    launches = fr.resblock_cluster_backward_cuda.launches - before
    again = autograd_grads(lambda a, b: fr.fused_resblock_cluster(a, b, spec), x, w, g)
    want = autograd_grads(lambda a, b: fr.resblock_cluster_plain(a, b, spec), x, w, g)
    ref = autograd_grads(lambda a, b: fr.resblock_cluster_plain(a, b, spec), x.double(),
                         [t.double() for t in w], g.double())
    gerr = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
               for a, b in zip(got, want))
    err_k, err_p = grad_errors(got, ref), grad_errors(want, ref)
    worst = max(err_k) / max(err_p)
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (gerr <= 1e-4 and worst <= BWD_ERR_RATIO and bit_equal
          and launches == fr.backward_launches(spec))
    emit("autograd", shape=[1, 64, 704], max_rel_grad_err=gerr, ok=ok,
         f64_rel_l2_kernel_max=max(err_k), f64_rel_l2_plain_max=max(err_p),
         worst_err_ratio=worst, err_ratio_tol=BWD_ERR_RATIO,
         per_tensor_max_ratio=max(k / p for k, p in zip(err_k, err_p)), bit_equal=bit_equal,
         backward_launches=launches, expected_launches=fr.backward_launches(spec))
    if not ok:
        raise AssertionError(f"autograd gradients disagree: {gerr}, ratio {worst}, "
                             f"bit_equal {bit_equal}, launches {launches}")


def phase_cluster_backward(fr, spec):
    """The cluster backward's kernels (``resblock_cluster_backward_cuda``)
    at the vocoder training stage shapes and [1, 64, 704], TF32 off: its
    gradients against the plain twin (``resblock_cluster_backward_plain`` in
    f32, cuDNN) and both, with the plain f32 path (autograd through
    ``resblock_cluster_plain``), against float64 (that autograd in f64);
    the worst tensor's relative L2 error within BWD_ERR_RATIO times the
    plain f32 path's worst and the twin's; two calls bit-equal; launches
    per stage; device times (median of 10 calls between events) beside the
    least time of recompute + dgrad + wgrad (three times the forward's
    FLOPs at the f32 FFMA peak) and beside the plain path's and the twin's,
    with a ``torch.profiler`` split of one call by kernel. Returns the
    rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsvb_torch.utils.profiling import median_ms, roofline, top_ops
    gen = torch.Generator().manual_seed(17)
    rows = []
    for B, C, T in BWD_SHAPES:
        x = torch.randn(B, C, T, generator=gen).cuda()
        w = random_cluster(C, spec, gen, "cuda")
        g = torch.randn(B, C, T, generator=gen).cuda()
        flop = 3 * cluster_work(B, C, T, spec, 4)[0]

        def kernels():
            gx, gw = fr.resblock_cluster_backward_cuda(x, w, spec, g)
            return [gx] + gw

        def twin():
            gx, gw = fr.resblock_cluster_backward_plain(x, w, spec, g)
            return [gx] + gw

        def plain():
            return autograd_grads(lambda a, b: fr.resblock_cluster_plain(a, b, spec), x, w, g)

        before = fr.resblock_cluster_backward_cuda.launches
        got = kernels()
        launches = fr.resblock_cluster_backward_cuda.launches - before
        again = kernels()
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ref = autograd_grads(lambda a, b: fr.resblock_cluster_plain(a, b, spec), x.double(),
                             [t.double() for t in w], g.double())
        tw = twin()
        err_k, err_t, err_p = grad_errors(got, ref), grad_errors(tw, ref), grad_errors(plain(), ref)
        vs_twin = max(float((a - b).norm() / b.norm()) for a, b in zip(got, tw))
        del ref, got, tw
        ratio_p, ratio_t = max(err_k) / max(err_p), max(err_k) / max(err_t)
        kernel_ms = median_ms(kernels, n=10)
        plain_ms = median_ms(plain, n=10)
        twin_ms = median_ms(twin, n=10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels()
            torch.cuda.synchronize()
        split = [[name[:80], s * 1e3, n] for name, s, n in top_ops(prof, k=12)]
        bound, share, _ = roofline(flop, 0, kernel_ms / 1e3, torch.float32)
        ok = (ratio_p <= BWD_ERR_RATIO and ratio_t <= BWD_ERR_RATIO and bit_equal
              and launches == fr.backward_launches(spec))
        row = dict(B=B, C=C, T=T, ok=ok, bit_equal=bit_equal, launches=launches,
                   expected_launches=fr.backward_launches(spec), vs_twin_rel_l2=vs_twin,
                   f64_rel_l2_kernel=err_k, f64_rel_l2_twin=err_t, f64_rel_l2_plain=err_p,
                   worst_ratio_plain=ratio_p, worst_ratio_twin=ratio_t,
                   per_tensor_max_ratio_plain=max(k / p for k, p in zip(err_k, err_p)),
                   ratio_tol=BWD_ERR_RATIO, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   twin_ms=twin_ms, gflop=flop / 1e9, bound_ms=bound * 1e3,
                   bound_share=share, kernel_tflops=flop / kernel_ms / 1e9, split_ms=split)
        emit("cluster_backward", **row)
        if not ok:
            raise AssertionError(f"cluster backward kernels: {row}")
        rows.append(row)
        del x, w, g
    train = rows[:len(TRAIN_SHAPES)]
    emit("cluster_backward_train_step",
         kernel_ms=sum(r["kernel_ms"] for r in train),
         plain_ms=sum(r["plain_ms"] for r in train),
         twin_ms=sum(r["twin_ms"] for r in train),
         bound_ms=sum(r["bound_ms"] for r in train),
         launches=sum(r["launches"] for r in train))
    return rows


def cluster_backward_main():
    """``python3 chip_smoke.py --cluster-backward``: the environment line,
    the build of the cluster's libraries, the autograd check and
    ``phase_cluster_backward`` alone (a few minutes on one card)."""
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import torch
    from neuralsvb_torch.ops import dilated_conv, fused_resblock as fr
    if not torch.cuda.is_available():
        raise RuntimeError("the cluster backward's phase needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi.splitlines()[0])
    tf32(False)
    build_all({"resblock_bf16": fr.LIBRARY_BF16, "dilated_conv_backward": dilated_conv.LIBRARY})
    spec = fr.make_spec((3, 7, 11), ((1, 3, 5),) * 3)
    phase_autograd(fr, spec, torch.Generator().manual_seed(0))
    phase_cluster_backward(fr, spec)
    print(json.dumps({"ok": True}), flush=True)


# BigVGAN-v2's Activation1d at the training cell's stage shapes: 4 crops of
# 256 frames through six stages of 768 ... 24 channels (the final
# activation's shape is the last stage's)
AMP_SHAPES = ((4, 768, 1024), (4, 384, 4096), (4, 192, 8192), (4, 96, 16384),
              (4, 48, 32768), (4, 24, 65536))
AMP_ERR_RATIO = 1.5  # the kernels' error vs float64 over the plain f32 path's
AMP_TWIN_TOL = 1e-4  # kernel vs plain twin, max|d| / max(1, max|ref|)
# per output element: upsample 2 x (6 multiply-adds + scale), SnakeBeta 2 x 5
# operations, downsample 12 multiply-adds; the backward recomputes the
# upsampling and adds the strided conv's transpose, the SnakeBeta
# derivatives and the upsampling's transpose
AMP_FWD_FLOP, AMP_BWD_FLOP = 60, 110
AMP_FWD_BYTES, AMP_BWD_BYTES = 8, 12  # x read, y written; x, dy read, dx written


def device_ms_by(fn, keys, n=10):
    """Device time per call of ``fn`` for each of ``keys``: the summed
    durations of the kernels whose name holds the key (every kernel for
    ``""``) in a ``torch.profiler`` trace of ``n`` calls, over n (host
    issue left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsvb_torch.utils.profiling import top_ops
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = top_ops(prof, k=1000)
    return {key: sum(t for name, t, _ in ops if key in name) * 1e3 / n for key in keys}


def kernel_device_ms(fn, key="", n=10):
    """``device_ms_by`` for one key."""
    return device_ms_by(fn, (key,), n)[key]


def phase_amp(amp):
    """BigVGAN's fused anti-aliased SnakeBeta (``ops/amp_activation.py``)
    at ``AMP_SHAPES``, TF32 off: the forward kernel and the backward kernels
    (dx, dalpha, dbeta) against the plain twins
    (``activation1d_plain``/``activation1d_backward_plain``) within
    AMP_TWIN_TOL, and both, with the plain f32 path (autograd through
    ``activation1d_plain``), against float64 autograd: the worst tensor's
    relative L2 error within AMP_ERR_RATIO times the plain f32 path's; two
    backward calls bit-equal; 1 + 2 launches; device times beside the
    bound (bytes at the HBM peak or the operations at the f32 peak, the
    larger) and the plain path's. Device times are the kernels' durations
    in a profile of 10 calls (``kernel_device_ms``): a call's host issue
    (``bwd_call_ms``, between events) is longer than its kernels. Returns
    the rows."""
    import torch
    from neuralsvb_torch.utils.profiling import median_ms, roofline
    gen = torch.Generator().manual_seed(23)
    rows = []
    for B, C, T in AMP_SHAPES:
        # activations of the scale the seeded cell's stages reach
        x = (4 * torch.randn(B, C, T, generator=gen)).cuda()
        a = (0.05 * torch.randn(C, generator=gen)).cuda()
        b = (0.05 * torch.randn(C, generator=gen)).cuda()
        g = torch.randn(B, C, T, generator=gen).cuda()
        n = B * C * T
        amp.amp_forward_cuda(x, a, b)  # the library's build and load
        before = amp.amp_forward_cuda.launches, amp.amp_backward_cuda.launches
        y = amp.amp_forward_cuda(x, a, b)
        got = list(amp.amp_backward_cuda(x, a, b, g))
        launches = (amp.amp_forward_cuda.launches - before[0],
                    amp.amp_backward_cuda.launches - before[1])
        again = list(amp.amp_backward_cuda(x, a, b, g))
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(p, q) for p, q in zip(got, again))
        y_twin = amp.activation1d_plain(x, a, b)
        twin = list(amp.activation1d_backward_plain(x, a, b, g))
        vs_twin = [float((p - q).abs().max()) / max(1.0, float(q.abs().max()))
                   for p, q in zip([y] + got, [y_twin] + twin)]
        x64, a64, b64 = (t.double().requires_grad_(True) for t in (x, a, b))
        y64 = amp.activation1d_plain(x64, a64, b64)
        ref = [y64.detach()] + list(torch.autograd.grad((y64 * g.double()).sum(),
                                                        [x64, a64, b64]))
        del x64, a64, b64, y64
        xp, ap, bp = (t.clone().requires_grad_(True) for t in (x, a, b))
        yp = amp.activation1d_plain(xp, ap, bp)
        plain = [yp.detach()] + list(torch.autograd.grad((yp * g).sum(), [xp, ap, bp]))
        del xp, ap, bp, yp
        err_k, err_p = grad_errors([y] + got, ref), grad_errors(plain, ref)
        del ref, plain, twin, again
        ratio = max(err_k) / max(err_p)
        fwd_ms = kernel_device_ms(lambda: amp.amp_forward_cuda(x, a, b), "amp_activation")
        bwd_ms = kernel_device_ms(lambda: amp.amp_backward_cuda(x, a, b, g), "amp_activation")
        call_ms = median_ms(lambda: amp.amp_backward_cuda(x, a, b, g), n=10)

        def plain_step():
            xq, aq, bq = (t.clone().requires_grad_(True) for t in (x, a, b))
            return torch.autograd.grad((amp.activation1d_plain(xq, aq, bq) * g).sum(),
                                       [xq, aq, bq])
        plain_fwd_ms = kernel_device_ms(lambda: amp.activation1d_plain(x, a, b))
        plain_ms = kernel_device_ms(plain_step)
        fb, _, fwd_by = roofline(AMP_FWD_FLOP * n, AMP_FWD_BYTES * n, fwd_ms / 1e3,
                                 torch.float32)
        bb, _, bwd_by = roofline(AMP_BWD_FLOP * n, AMP_BWD_BYTES * n, bwd_ms / 1e3,
                                 torch.float32)
        ok = (ratio <= AMP_ERR_RATIO and bit_equal and launches == (1, 2)
              and max(vs_twin) <= AMP_TWIN_TOL)
        row = dict(B=B, C=C, T=T, ok=ok, launches=launches, bit_equal=bit_equal,
                   vs_twin_max_rel=vs_twin, twin_tol=AMP_TWIN_TOL,
                   f64_rel_l2_kernel=err_k, f64_rel_l2_plain=err_p, worst_ratio=ratio,
                   ratio_tol=AMP_ERR_RATIO, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                   bwd_call_ms=call_ms,
                   fwd_bound_ms=fb * 1e3, bwd_bound_ms=bb * 1e3,
                   bound_share=(fb + bb) * 1e3 / (fwd_ms + bwd_ms),
                   bound_by=[BOUND_BY[fwd_by], BOUND_BY[bwd_by]],
                   plain_fwd_ms=plain_fwd_ms, plain_fwd_bwd_ms=plain_ms)
        emit("amp_kernel", **row)
        if not ok:
            raise AssertionError(f"AMP kernels: {row}")
        rows.append(row)
        del x, a, b, g, y, got
    # the cell's step: 18 activations per stage and one final, forward and
    # backward
    counts = [18] * len(AMP_SHAPES)
    counts[-1] += 1
    emit("amp_train_step", fwd_ms=sum(c * r["fwd_ms"] for c, r in zip(counts, rows)),
         bwd_ms=sum(c * r["bwd_ms"] for c, r in zip(counts, rows)),
         bound_ms=sum(c * (r["fwd_bound_ms"] + r["bwd_bound_ms"]) for c, r in zip(counts, rows)),
         plain_fwd_bwd_ms=sum(c * r["plain_fwd_bwd_ms"] for c, r in zip(counts, rows)),
         activations=sum(counts))
    return rows


# BigVGAN-v2's tower convolutions at the training cell's stage shapes: per
# stage and kernel size 6 convolutions a step, 4 at dilation 1 (three
# second convolutions and the first of the dilations 1, 3, 5), 1 at 3, 1 at 5
AMP_CONV_KS = (3, 7, 11)
AMP_CONV_DILATIONS = {1: 4, 3: 1, 5: 1}
# the kernels' error vs float64 over the plain f32 path's: the dgrad sums an
# output's C K products (up to 8,448) in one chain, and its error (about
# 1e-6 relative L2) reaches about 3x cuDNN's (measured on an H100: up to
# 1.91x the plain path's worst tensor)
AMP_CONV_ERR_RATIO = 3.0
AMP_CONV_TWIN_TOL = 1e-4  # kernels vs plain twin, max|d| / max(1, max|ref|)


def phase_amp_conv_backward(ac):
    """The AMP towers' convolution backward (``ops/amp_conv.py``) at the
    six stage shapes of ``bigvgan_train`` (4 crops of 256 frames, 768 ...
    24 channels), K 3/7/11 at dilations 1, 3, 5, TF32 off: the kernels'
    dx, dW and db against the plain twin (``amp_conv_backward_plain``,
    f32) within AMP_CONV_TWIN_TOL and, with the plain f32 path (autograd
    through ``F.conv1d``), against float64 autograd: the worst tensor's
    relative L2 error within AMP_CONV_ERR_RATIO times the plain path's; two
    calls bit-equal; one count a call. Device times from a profile of 5
    calls: dgrad, wgrad, reduction and all kernels of a call (the weight's
    copy included), and the plain path's backward; per call between
    events (``call_ms``: dgrad and wgrad overlap on two streams). The step
    sums each row times its convolutions a step (AMP_CONV_DILATIONS) and
    puts it beside the least time, 2 x 2 B C^2 T K FLOPs at the f32 FFMA
    peak. Returns the rows."""
    import torch
    import torch.nn.functional as F
    from neuralsvb_torch.utils.profiling import median_ms, roofline
    gen = torch.Generator().manual_seed(29)
    rows = []
    for B, C, T in AMP_SHAPES:
        for K in AMP_CONV_KS:
            for d in AMP_CONV_DILATIONS:
                x = torch.randn(B, C, T, generator=gen).cuda()
                w = (torch.randn(C, C, K, generator=gen) / (C * K) ** 0.5).cuda()
                bias = torch.zeros(C).cuda()
                g = torch.randn(B, C, T, generator=gen).cuda()
                pad = (K - 1) // 2 * d
                before = ac.amp_conv_backward_cuda.launches
                got = list(ac.amp_conv_backward_cuda(x, w, g, d))
                launches = ac.amp_conv_backward_cuda.launches - before
                again = list(ac.amp_conv_backward_cuda(x, w, g, d))
                torch.cuda.synchronize()
                bit_equal = all(torch.equal(p, q) for p, q in zip(got, again))
                del again
                twin = list(ac.amp_conv_backward_plain(x, w, g, d))
                vs_twin = [float((p - q).abs().max()) / max(1.0, float(q.abs().max()))
                           for p, q in zip(got, twin)]
                del twin
                ref = autograd_grads(
                    lambda a, p: F.conv1d(a, p[0], p[1], padding=pad, dilation=d),
                    x.double(), [w.double(), bias.double()], g.double())
                plain = autograd_grads(
                    lambda a, p: F.conv1d(a, p[0], p[1], padding=pad, dilation=d),
                    x, [w, bias], g)
                err_k, err_p = grad_errors(got, ref), grad_errors(plain, ref)
                del ref, plain, got
                ratio = max(err_k) / max(err_p)
                ms = device_ms_by(lambda: ac.amp_conv_backward_cuda(x, w, g, d),
                                  ("dilated_conv_dgrad", "dilated_conv_wgrad",
                                   "dilated_conv_reduce", ""), n=5)
                call_ms = median_ms(lambda: ac.amp_conv_backward_cuda(x, w, g, d), n=10)
                xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, bias))
                y = F.conv1d(xs, ws, bs, padding=pad, dilation=d)
                plain_ms = kernel_device_ms(
                    lambda: torch.autograd.grad(y, [xs, ws, bs], g, retain_graph=True), n=5)
                del xs, ws, bs, y
                flop = 2 * 2 * B * C * C * T * K
                bound, share, _ = roofline(flop, 0, ms[""] / 1e3, torch.float32)
                ok = (ratio <= AMP_CONV_ERR_RATIO and bit_equal and launches == 1
                      and max(vs_twin) <= AMP_CONV_TWIN_TOL)
                row = dict(B=B, C=C, T=T, K=K, d=d, per_step=AMP_CONV_DILATIONS[d], ok=ok,
                           launches=launches, bit_equal=bit_equal, vs_twin_max_rel=vs_twin,
                           f64_rel_l2_kernel=err_k, f64_rel_l2_plain=err_p,
                           worst_ratio=ratio, ratio_tol=AMP_CONV_ERR_RATIO,
                           dgrad_ms=ms["dilated_conv_dgrad"], wgrad_ms=ms["dilated_conv_wgrad"],
                           reduce_ms=ms["dilated_conv_reduce"], kernel_ms=ms[""],
                           call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound * 1e3,
                           bound_share=share, kernel_tflops=flop / ms[""] / 1e9)
                emit("amp_conv_backward", **row)
                if not ok:
                    raise AssertionError(f"AMP conv backward kernels: {row}")
                rows.append(row)
                del x, w, bias, g

    def step(key):
        return sum(r["per_step"] * r[key] for r in rows)

    by_stage = {}
    for r in rows:
        by_stage.setdefault(r["C"], [0.0, 0.0, 0.0])
        for i, key in enumerate(("kernel_ms", "plain_ms", "bound_ms")):
            by_stage[r["C"]][i] += r["per_step"] * r[key]
    emit("amp_conv_train_step", convs=step("launches"), dgrad_ms=step("dgrad_ms"),
         wgrad_ms=step("wgrad_ms"), reduce_ms=step("reduce_ms"), kernel_ms=step("kernel_ms"),
         call_ms=step("call_ms"), plain_ms=step("plain_ms"), bound_ms=step("bound_ms"),
         bound_share=step("bound_ms") / step("kernel_ms"),
         worst_f64_ratio=max(r["worst_ratio"] for r in rows),
         by_stage_kernel_plain_bound_ms=by_stage)
    return rows


# BigVGAN's MRD at the bigvgan_train cell's shapes (4 crops of 65536
# samples); a step runs the discriminators' two passes (dW, db and dx below
# the first layer) and the generator's pass (dx alone) through the kernels
MRD_SAMPLES, MRD_BATCH = 65536, 4
MRD_ERR_RATIO = 3.0   # a tensor's error vs float64 over the plain f32 path's, as the towers'
MRD_TWIN_TOL = 1e-4   # kernels vs plain twin, max|d| / max(1, max|ref|)


def mrd_layer_shapes():
    """(resolution, layer, (kw, sw, ci, co), H, Wi) of the cell's 18 MRD
    convolutions, read from ``DiscriminatorR``'s layers: H = n_fft / 2 + 1
    bins, Wi the frames of the reflect-padded signal, halved (rounded up)
    by each stride-2 layer."""
    from neuralsvb_torch.models.bigvgan import MRD_RESOLUTIONS, DiscriminatorR
    out = []
    for res in MRD_RESOLUTIONS:
        n_fft, hop, _ = res
        d = DiscriminatorR(res)
        wi = (MRD_SAMPLES + 2 * ((n_fft - hop) // 2) - n_fft) // hop + 1
        for j, conv in enumerate(list(d.convs) + [d.conv_post]):
            co, ci, _, kw = conv.weight.shape
            sw = conv.stride[1]
            out.append((n_fft, j, (kw, sw, ci, co), n_fft // 2 + 1, wi))
            wi = (wi - 1) // sw + 1
    return out


def phase_mrd_conv_backward(mc):
    """The MRD's convolution backward (``ops/mrd_conv.py``) at the 18 layer
    shapes of ``bigvgan_train``, TF32 off, in both of a step's calls: the
    discriminators' (dW, db and dx but below the first layer, whose input
    is data) and the generator's (dx alone). From cuDNN's forward and the
    activation, each tensor the kernels compute against the plain twin
    (``mrd_conv_backward_plain``, f32) within MRD_TWIN_TOL and, with the
    plain f32 path (autograd through ``F.conv2d`` and the leaky-ReLU),
    against float64 autograd: each tensor's relative L2 error within
    MRD_ERR_RATIO times the plain path's error of the same tensor; two
    calls bit-equal; one count a call. Device times of each call from a
    profile of 5 calls, by kernel (dgrad, wgrad, reduction, all with the
    weight's permute), and between events (``call_ms``: dgrad and wgrad
    overlap on two streams); cuDNN's autograd for the same calls. The step
    sums the discriminators' two calls and the generator's one over the 18
    layers and puts them beside their least time, the FLOPs at the f32
    FFMA peak. Returns the rows."""
    import torch
    import torch.nn.functional as F
    from neuralsvb_torch.utils.profiling import median_ms, roofline
    gen = torch.Generator().manual_seed(31)
    keys = ("mrd_conv_dgrad", "mrd_conv_wgrad", "dilated_conv_reduce", "")
    rows = []
    for n_fft, j, (kw, sw, ci, co), H, wi in mrd_layer_shapes():
        lrelu = co != 1
        x = torch.randn(MRD_BATCH, ci, H, wi, generator=gen).cuda()
        w = (torch.randn(co, ci, 3, kw, generator=gen) / (ci * 3 * kw) ** 0.5).cuda()
        b = (0.1 * torch.randn(co, generator=gen)).cuda()

        def act(t):
            return torch.where(t >= 0, t, t * mc.LRELU_SLOPE) if lrelu else t

        def fwd(a, p):
            return act(F.conv2d(a, p[0], p[1], (1, sw), (1, kw // 2)))
        y = fwd(x, [w, b])
        dy = torch.randn(y.shape, generator=gen).cuda()
        disc_dx = j > 0  # the discriminators' call: the first layer's input is data

        def disc():
            return mc.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu, need_dx=disc_dx)

        def gen_pass():
            return mc.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu, need_dw=False)
        before = mc.mrd_conv_backward_cuda.launches
        got_d, got_g = disc(), gen_pass()
        launches = mc.mrd_conv_backward_cuda.launches - before
        again_d, again_g = disc(), gen_pass()
        torch.cuda.synchronize()
        # dx, dW, db: the generator's dx, the discriminators' dW and db
        got = [got_g[0], got_d[1], got_d[2]]
        bit_equal = (all(torch.equal(p, q) for p, q in zip(got_d, again_d) if p is not None)
                     and torch.equal(got_g[0], again_g[0])
                     and (not disc_dx or torch.equal(got_d[0], got_g[0])))
        del again_d, again_g, got_d, got_g
        twin = list(mc.mrd_conv_backward_plain(x, w, y, dy, sw, lrelu))
        vs_twin = [float((p - q).abs().max()) / max(1.0, float(q.abs().max()))
                   for p, q in zip(got, twin)]
        del twin
        ref = autograd_grads(fwd, x.double(), [w.double(), b.double()], dy.double())
        plain = autograd_grads(fwd, x, [w, b], dy)
        err_k, err_p = grad_errors(got, ref), grad_errors(plain, ref)
        del ref, plain, got
        ratios = [k / p for k, p in zip(err_k, err_p)]
        ms_d = device_ms_by(disc, keys, n=5)
        ms_g = device_ms_by(gen_pass, keys, n=5)
        call_ms = 2 * median_ms(disc, n=10) + median_ms(gen_pass, n=10)

        def cudnn_ms(on_x, on_w):
            xs = x.clone().requires_grad_(on_x)
            ws, bs = (t.clone().requires_grad_(on_w) for t in (w, b))
            out = fwd(xs, [ws, bs])
            wrt = [t for t, on in ((xs, on_x), (ws, on_w), (bs, on_w)) if on]
            return kernel_device_ms(
                lambda: torch.autograd.grad(out, wrt, dy, retain_graph=True), n=5)
        cudnn_disc_ms, cudnn_gen_ms = cudnn_ms(disc_dx, True), cudnn_ms(True, False)
        flop = 2 * MRD_BATCH * H * y.shape[-1] * co * ci * 3 * kw  # one dgrad or wgrad
        step_flop = 2 * (flop * disc_dx + flop) + flop

        def step_ms(key):
            return 2 * ms_d[key] + ms_g[key]
        bound, share, _ = roofline(step_flop, 0, step_ms("") / 1e3, torch.float32)
        ok = (max(ratios) <= MRD_ERR_RATIO and bit_equal and launches == 2
              and max(vs_twin) <= MRD_TWIN_TOL)
        row = dict(n_fft=n_fft, layer=j, geometry=[kw, sw, ci, co], H=H, Wi=wi, Wo=y.shape[-1],
                   ok=ok, launches=launches, bit_equal=bit_equal, vs_twin_max_rel=vs_twin,
                   f64_rel_l2_kernel=err_k, f64_rel_l2_plain=err_p, ratios=ratios,
                   ratio_tol=MRD_ERR_RATIO, dgrad_ms=step_ms("mrd_conv_dgrad"),
                   gen_dgrad_ms=ms_g["mrd_conv_dgrad"], wgrad_ms=step_ms("mrd_conv_wgrad"),
                   reduce_ms=step_ms("dilated_conv_reduce"), kernel_ms=step_ms(""),
                   call_ms=call_ms, cudnn_ms=2 * cudnn_disc_ms + cudnn_gen_ms,
                   bound_ms=bound * 1e3, bound_share=share,
                   kernel_tflops=step_flop / step_ms("") / 1e9)
        emit("mrd_conv_backward", **row)
        if not ok:
            raise AssertionError(f"MRD conv backward kernels: {row}")
        rows.append(row)
        del x, w, b, y, dy

    def step(key):
        return sum(r[key] for r in rows)

    emit("mrd_conv_train_step", convs=3 * len(rows), dgrad_ms=step("dgrad_ms"),
         gen_dgrad_ms=step("gen_dgrad_ms"), wgrad_ms=step("wgrad_ms"),
         reduce_ms=step("reduce_ms"), kernel_ms=step("kernel_ms"), cudnn_ms=step("cudnn_ms"),
         bound_ms=step("bound_ms"), bound_share=step("bound_ms") / step("kernel_ms"),
         call_ms=step("call_ms"),
         worst_f64_ratio=[max(r["ratios"][i] for r in rows) for i in range(3)])
    return rows


def write_bigvgan_split(data_dir, hp, seconds, prefix, seed):
    """A packed split of sung vibrato crops at the recipe's rate with their
    log-mels (``synthetic_crops``), one item of about ``seconds`` each."""
    from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder
    from neuralsvb_torch.data.synthetic import synthetic_crops
    os.makedirs(data_dir, exist_ok=True)
    hop = hp["hop_size"]
    builder = IndexedDatasetBuilder(os.path.join(data_dir, prefix))
    for i, sec in enumerate(seconds):
        n = int(sec * hp["audio_sample_rate"]) // hop * hop
        c = synthetic_crops(1, dict(hp, max_samples=n), seed=seed + i)
        builder.add_item({"item_name": f"{prefix}_{i}", "wav": c["wavs"][0],
                          "mel": c["mels"][0], "f0": c["f0"][0]})
    builder.finalize()


BIGVGAN_RECIPE = "egs/datasets/audio/PopBuTFy/bigvgan_v2_24k_torch.yaml"
BIGVGAN_STEPS, BIGVGAN_VALID_ITEMS = 3, 2
BIGVGAN_AMP_CALLS = 6 * 18 + 1  # Activation1d calls a generator pass: 18 a stage, the final
BIGVGAN_TOWER_CONVS = 6 * 18  # AMPBlock1 convolutions: 3 towers x 6 a stage
BIGVGAN_MRD_CONVS = 3 * 6 * 3  # MRD convolution backwards in the kernels: 3 x 6, 3 passes a step
BIGVGAN_KEYS = {"mel", "a_p", "a_r", "fm", "r_p", "f_p", "r_r", "f_r"}


def phase_bigvgan_train(device="cuda"):
    """BigVGAN-v2's recipe (``bigvgan_v2_24k_torch.yaml``) through ``python
    -m neuralsvb_torch.tasks.run`` at its published widths and per-card
    batch (1536 channels, six stages, 4 crops of 65536 samples) on a
    synthetic 24 kHz split (6 sung items of 3 s train, 2 of 1.5 s
    validate), seeded weights, BIGVGAN_STEPS steps of the generator, MPD and
    MRD, validating at the start and at the end. Every logged loss is finite
    with BIGVGAN_KEYS among its keys; the training process zeroes its counts
    when fit starts and reports them in its summary: the AMP kernels launch
    BIGVGAN_AMP_CALLS forward a generator call (each training step and each
    validation batch) and twice that backward a step, the towers'
    convolution backward BIGVGAN_TOWER_CONVS a step, the MRD's
    BIGVGAN_MRD_CONVS a step, the HiFiGAN cluster's kernels never. Returns
    the summary's launch counts."""
    import math
    import yaml
    from neuralsvb_torch.hparams import set_hparams
    hp = set_hparams(config=BIGVGAN_RECIPE, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    data = os.path.join(WORK, "bigvgan_data")
    write_bigvgan_split(data, hp, [3.0] * 6, "train", seed=181)
    write_bigvgan_split(data, hp, [1.5] * BIGVGAN_VALID_ITEMS, "valid", seed=281)
    cfg = os.path.join(WORK, "bigvgan_train.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"base_config": [os.path.join(REPO, BIGVGAN_RECIPE)],
                        "binary_data_dir": data, "device": device,
                        "max_updates": BIGVGAN_STEPS, "val_check_interval": BIGVGAN_STEPS,
                        "num_sanity_val_steps": BIGVGAN_VALID_ITEMS, "tb_log_interval": 1}, f)
    out, wall = run_train_cli(cfg, os.path.join(WORK, "bigvgan_work"))
    s = summary_of(out, "train")
    bad = []
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
    if sorted(steps) != list(range(1, BIGVGAN_STEPS + 1)):
        bad.append(f"logged steps {sorted(steps)}")
    for n, logs in steps.items():
        if not BIGVGAN_KEYS <= set(logs) or not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {n} logs {logs}")
    validations = out.count("| Valid results:")
    calls = s["vocoder_calls"]
    trained = s["end_step"] - s["start_step"]
    on_card = device == "cuda"
    want = {"amp_forward_cuda_launches": BIGVGAN_AMP_CALLS * calls * on_card,
            "amp_backward_cuda_launches": 2 * BIGVGAN_AMP_CALLS * trained * on_card,
            "amp_conv_backward_cuda_launches": BIGVGAN_TOWER_CONVS * trained * on_card,
            "mrd_conv_backward_cuda_launches": BIGVGAN_MRD_CONVS * trained * on_card,
            "resblock_conv1d_bf16_launches": 0, "resblock_conv1d_launches": 0,
            "resblock_cluster_backward_cuda_launches": 0}
    launches = {k: s[k] for k in want}
    if trained != BIGVGAN_STEPS or calls != trained + BIGVGAN_VALID_ITEMS * validations \
            or launches != want:
        bad.append(f"{trained} steps, {calls} generator calls, {validations} validations, "
                   f"launches {launches} != {want}")
    emit("bigvgan_train", ok=not bad, problems=bad, wall_s=wall, summary=s,
         validations=validations, generator_calls=calls, launches=launches,
         expected_launches=want, last_step_losses=steps.get(BIGVGAN_STEPS))
    if bad:
        raise AssertionError(f"BigVGAN train phase failed: {bad}")
    return dict(launches, generator_calls=calls, steps=trained,
                max_memory_allocated=s.get("max_memory_allocated"))


def amp_main():
    """``python3 chip_smoke.py --amp``: the environment line, the build of
    the AMP library, ``phase_amp`` and ``phase_bigvgan_train`` alone (a
    minute or two on one card)."""
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import torch
    from neuralsvb_torch.ops import amp_activation as amp
    if not torch.cuda.is_available():
        raise RuntimeError("the AMP phase needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi.splitlines()[0])
    tf32(False)
    build_all({"amp_activation": amp.LIBRARY})
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase_amp(amp)
    phase_bigvgan_train()
    print(json.dumps({"ok": True}), flush=True)


def kernel_phases_main(what, libs, phases):
    """The environment line, the build of the libraries ``libs`` (name ->
    ``SharedLibrary`` of the port) and the calls ``phases`` alone, in a
    fresh work directory; ``what`` names the run where there is no card."""
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi.splitlines()[0])
    tf32(False)
    build_all(libs)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    for phase in phases:
        phase()
    print(json.dumps({"ok": True}), flush=True)


def amp_conv_backward_main():
    """``python3 chip_smoke.py --amp-conv-bwd``: the environment line, the
    build of the library, ``phase_amp_conv_backward`` and
    ``phase_bigvgan_train`` alone (a few minutes on one card)."""
    sys.path.insert(0, REPO)
    from neuralsvb_torch.ops import amp_conv, dilated_conv
    kernel_phases_main("the AMP conv backward's phase",
                       {"dilated_conv_backward": dilated_conv.LIBRARY},
                       [lambda: phase_amp_conv_backward(amp_conv), phase_bigvgan_train])


def mrd_conv_backward_main():
    """``python3 chip_smoke.py --mrd-conv-bwd``: the environment line, the
    build of the libraries BigVGAN's training runs, ``phase_mrd_conv_backward``
    and ``phase_bigvgan_train`` alone (a few minutes on one card)."""
    sys.path.insert(0, REPO)
    from neuralsvb_torch.ops import amp_activation, dilated_conv, mrd_conv
    kernel_phases_main("the MRD conv backward's phase",
                       {"mrd_conv_backward": mrd_conv.LIBRARY,
                        "dilated_conv_backward": dilated_conv.LIBRARY,
                        "amp_activation": amp_activation.LIBRARY},
                       [lambda: phase_mrd_conv_backward(mrd_conv), phase_bigvgan_train])


def vocoder_keys():
    """The HiFiGAN-NSF generator of the PopBuTFy vocoder recipe."""
    from neuralsvb_torch.hparams import load_config_recursive
    cfg = load_config_recursive("egs/datasets/audio/PopBuTFy/hifigan_nsf.yaml")
    keys = ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
            "resblock", "resblock_kernel_sizes", "resblock_dilation_sizes",
            "use_pitch_embed", "audio_sample_rate", "audio_num_mel_bins")
    return {k: cfg[k] for k in keys}


def phase_main_path(voc):
    import numpy as np
    import yaml
    from neuralsvb_torch.data.synthetic import write_synthetic_split
    data, voc_dir, work = (os.path.join(WORK, d) for d in ("data", "voc", "work"))
    write_synthetic_split(data, UTT_FRAMES, seed=1234)
    os.makedirs(voc_dir)
    with open(os.path.join(voc_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(voc, f)
    cfg = os.path.join(WORK, "infer.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({
            "base_config": [os.path.join(
                REPO, "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml")],
            "binary_data_dir": data, "vocoder_ckpt": voc_dir, "device": "cuda",
            "hidden_size": 256, "latent_size": 128, "fvae_enc_dec_hidden": 192,
            "fvae_kernel_size": 5, "fvae_enc_n_layers": 8, "fvae_dec_n_layers": 4,
            "asr_enc_layers": 2}, f)
    cmd = [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config", cfg,
           "--infer", "--hparams", f"work_dir={work}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"--infer failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    m = re.search(r"^\| infer summary: (\{.*\})$", proc.stdout, re.M)
    if m is None:
        raise RuntimeError(f"no infer summary in the output:\n{proc.stdout[-4000:]}")
    summary = json.loads(m.group(1))
    gen_dir = os.path.join(work, "generated_0_")
    n_wavs = n_mels = 0
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        wavs = sorted(glob.glob(f"{gen_dir}/wavs/{key}_wavout/*.wav"))
        mels = sorted(glob.glob(f"{gen_dir}/mels/{key}_mel/*.npy"))
        if len(wavs) != len(UTT_FRAMES) or len(mels) != len(UTT_FRAMES):
            raise AssertionError(f"{key}: {len(wavs)} wavs, {len(mels)} mels")
        for wf, mf in zip(wavs, mels):
            mel = np.load(mf)
            with wave.open(wf) as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            if not np.isfinite(mel).all() or pcm.shape[0] != mel.shape[0] * 128:
                raise AssertionError(f"{wf}: {pcm.shape[0]} samples for "
                                     f"{mel.shape[0]} frames")
            if np.sqrt(np.mean(pcm.astype(np.float64) ** 2)) < 1.0:
                raise AssertionError(f"{wf} is silent")
            n_wavs, n_mels = n_wavs + 1, n_mels + 1
    n_calls = 5 * len(UTT_FRAMES)
    stages = len(voc["upsample_rates"])
    launches = {k: summary[f"{k}_launches"]
                for k in ("resblock_conv1d_bf16", "lrelu_bf16", "resblock_conv1d")}
    expected = {"resblock_conv1d_bf16": 18 * stages * n_calls,
                "lrelu_bf16": stages * n_calls, "resblock_conv1d": 0}
    emit("main_path", wavs=n_wavs, mels=n_mels, wall_s=wall,
         infer_compute_s=summary["compute_sec"], audio_s=summary["audio_sec"],
         rtf=summary["rtf"], rtf_wall=wall / summary["audio_sec"],
         max_memory_allocated=summary["max_memory_allocated"],
         vocoder_calls=n_calls, launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return launches


def phase_card_vs_cpu(voc):
    """One utterance through the slice on the card and on the CPU in both
    mm dtypes; returns the f32 kernel's launches in its card run."""
    import torch
    from neuralsvb_torch.data.datasets import MultiSpkEmbDataset
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.models.hifigan import HifiGanGenerator
    from neuralsvb_torch.models.svb_vae import SVBVAE
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.ops.pitch_utils import denorm_f0
    hp = set_hparams(config=os.path.join(WORK, "infer.yaml"),
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp) as h:
        ds = MultiSpkEmbDataset("test")
        batch = ds.collater([ds[0]])
        Tp = int(batch["prof_mel_lengths"][0])
        f0 = denorm_f0(batch["prof_f0"], batch["prof_uv"], h)[:, :Tp]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = SVBVAE(100, hidden_size=256, latent_size=128, fvae_hidden=192,
                       fvae_kernel=5, fvae_enc_layers=8, fvae_dec_layers=4,
                       mel_strides=(2, 1, 1), asr_enc_layers=2).eval()
        gen = HifiGanGenerator(
            upsample_rates=voc["upsample_rates"],
            upsample_kernel_sizes=voc["upsample_kernel_sizes"],
            upsample_initial_channel=voc["upsample_initial_channel"],
            resblock=voc["resblock"],
            resblock_kernel_sizes=voc["resblock_kernel_sizes"],
            resblock_dilation_sizes=voc["resblock_dilation_sizes"]).eval()
    counters = (fr.resblock_conv1d, fr.resblock_conv1d_bf16, fr.lrelu_bf16)
    res, launches = {}, {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        g = gen.to(dev)
        t = {k: torch.as_tensor(batch[k], device=dev) for k in
             ("mels", "prof_mels", "pitch", "prof_pitch", "a2p_f0_alignment")}
        spk = torch.as_tensor(batch["multi_spk_emb"][:, 0], device=dev)
        with torch.no_grad():
            out = m(t["mels"], t["prof_mels"], t["pitch"], t["prof_pitch"], spk,
                    t["a2p_f0_alignment"], zero_noise=True)
            mel = out["a2p"]["mel_out"][:, :Tp]
            for mm in (torch.float32, torch.bfloat16):
                g.mm_dtype = mm
                for c in counters:
                    c.launches = 0
                wav = g(mel, torch.as_tensor(f0, device=dev), zero_noise=True)
                res[dev, mm] = (mel.cpu(), wav.cpu())
                if dev == "cuda":
                    launches[mm] = {c.__name__: c.launches for c in counters}
    stages = len(voc["upsample_rates"])
    want = {torch.float32: {"resblock_conv1d": 18 * stages, "resblock_conv1d_bf16": 0,
                            "lrelu_bf16": 0},
            torch.bfloat16: {"resblock_conv1d": 0, "resblock_conv1d_bf16": 18 * stages,
                             "lrelu_bf16": stages}}

    def d(a, b, reduce):
        return float(reduce((a - b).abs()))

    rows = {}
    for mm, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        (mel_c, wav_c), (mel_h, wav_h) = res["cuda", mm], res["cpu", mm]
        row = dict(mel_out_max_abs_err=d(mel_c, mel_h, torch.max),
                   wav_max_abs_err=d(wav_c, wav_h, torch.max),
                   wav_mean_abs_err=d(wav_c, wav_h, torch.mean), launches=launches[mm])
        ok = (row["mel_out_max_abs_err"] <= 1e-3 and launches[mm] == want[mm]
              and bool(torch.isfinite(wav_c).all()))
        if mm == torch.float32:
            ok = ok and row["wav_max_abs_err"] <= 1e-3
        else:
            row["cpu_bf16_f32_gap"] = d(wav_h, res["cpu", torch.float32][1], torch.mean)
            row["ratio"] = row["wav_mean_abs_err"] / row["cpu_bf16_f32_gap"]
            ok = (ok and row["wav_max_abs_err"] <= 2e-3
                  and row["ratio"] <= WAV_MEAN_RATIO)
        rows[name] = dict(row, ok=ok)
    ok = all(r["ok"] for r in rows.values())
    emit("card_vs_cpu", frames=Tp, tol_mel=1e-3, tol_wav_f32=1e-3, tol_wav_bf16=2e-3,
         wav_ratio_tol=WAV_MEAN_RATIO, ok=ok, **rows)
    if not ok:
        raise AssertionError(f"card vs CPU: {rows}")
    return launches[torch.float32]["resblock_conv1d"]


def phase_chi2(chi2):
    import torch
    from neuralsvb_torch.data.synthetic import chi2_inputs
    from neuralsvb_torch.utils.profiling import (device_ms, fast_loop_per_term, issue_rate,
                                                 median_ms, roofline, sass)
    per_term = fast_loop_per_term(sass(chi2.LIBRARY.path))
    if per_term is None:
        raise AssertionError(f"no branch-free division loop in {chi2.LIBRARY.path}")
    rate = issue_rate()
    rows, worst = [], 0.0
    for i, (S, T) in enumerate(CHI2_SHAPES):
        errs, swap_equal = [], True
        for a, b in chi2_inputs(S, T, seed=i):
            a = torch.as_tensor(a, dtype=torch.float32, device="cuda")
            b = torch.as_tensor(b, dtype=torch.float32, device="cuda")
            out = chi2.chi2_dist(a, b)
            ref = chi2.chi2_dist_plain(a, b)
            swapped = chi2.chi2_dist(b, a)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()) or out.shape != (S, T):
                raise AssertionError(f"chi2_dist: {tuple(out.shape)} at {(S, T)}")
            d = (out - ref).abs()
            errs.append((float(d.max()), float((d / ref.abs().clamp_min(1.0)).max())))
            swap_equal = swap_equal and bool(torch.equal(swapped, out.T))
        # timed on the histograms (the binarizer's inputs)
        a, b = (torch.as_tensor(x, dtype=torch.float32, device="cuda")
                for x in chi2_inputs(S, T, seed=i)[0])
        kernel_ms = median_ms(lambda: chi2.chi2_dist(a, b))
        dev_ms = device_ms(lambda: chi2.chi2_dist(a, b))
        plain_ms = median_ms(lambda: chi2.chi2_dist_plain(a, b))
        terms = S * T * 48
        bound, _, which = roofline(terms * CHI2_OPS_PER_TERM, 4 * (S + T) * 48 + 4 * S * T,
                                   dev_ms / 1e3, torch.float32)
        bound, bound_by = bound * 1e3, BOUND_BY[which]
        issue_ms = terms * per_term / 32 / rate * 1e3
        # the binarizer's two kinds: max|d| <= 1e-5; values outside the
        # branch-free division's range: max|d| / max(1, |ref|) <= 1e-5
        err = max(errs[0][0], errs[1][0])
        ok = err <= 1e-5 and errs[2][1] <= 1e-5 and swap_equal
        row = dict(S=S, T=T, M=48, max_abs_err=err, hist_err=errs[0][0],
                   random_rows_err=errs[1][0], out_of_range_max_abs_err=errs[2][0],
                   out_of_range_rel_err=errs[2][1], tol=1e-5, swap_equal=swap_equal, ok=ok,
                   kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms,
                   bound_us=bound * 1e3, bound_by=bound_by,
                   bound_share=bound / dev_ms, sass_per_term=per_term,
                   issue_bound_us=issue_ms * 1e3, issue_share=issue_ms / dev_ms,
                   kernel_gterms_per_s=terms / dev_ms / 1e6)
        emit("chi2_kernel_vs_plain", **row)
        if not ok:
            raise AssertionError(f"chi2 kernel disagrees with plain: {row}")
        rows.append(row)
        worst = max(worst, err)
    return rows, worst


def write_sung_pairs(root):
    """2 singers x 2 songs x 2 pieces of sung vibrato at 22050 Hz under
    ``root/processed/data/p1``; returns the processed dir."""
    import numpy as np
    from neuralsvb_torch.ops.audio import save_wav

    def sing(freq, dur, seed):
        rng = np.random.RandomState(seed)
        t = np.arange(int(SR * dur)) / SR
        vib = freq * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
        return 0.3 * np.sin(2 * np.pi * np.cumsum(vib) / SR) + 0.01 * rng.randn(len(t))

    out = os.path.join(root, "processed", "data", "p1")
    os.makedirs(out)
    for k, (spk, song, freq) in enumerate(SONGS):
        for idx in range(2):
            j = 2 * k + idx
            base = f"{out}/{spk}#singing#{song}"
            save_wav(sing(freq * 1.02, AMATEUR_SECONDS[j], j), f"{base}_Amateur_{idx}.wav", SR)
            save_wav(sing(freq, AMATEUR_SECONDS[j] * PROF_FACTOR[j], 100 + j),
                     f"{base}_Professional_{idx}.wav", SR)
    return os.path.dirname(os.path.dirname(out))


def binarize_configs(root, processed):
    """The two passes' configs: the port's PopBuTFy yamls, pointed at
    ``root``; ``ge2e_ckpt: ''`` gives seeded GE2E weights."""
    import yaml
    cfgs = {}
    for name in ("save_emb_torch", "para_bin_torch"):
        cfgs[name] = os.path.join(root, f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump({
                "base_config": [os.path.join(
                    REPO, f"egs/datasets/audio/PopBuTFy/{name}.yaml")],
                "processed_data_dir": processed,
                "binary_data_dir": os.path.join(root, "binary"),
                "spk_emb_data_dir": os.path.join(root, "spk_emb"),
                "test_prefixes": ["Male6#singing#"], "ge2e_ckpt": "",
                "ds_workers": 1}, f)
    return cfgs


def run_binarize(cfg, device):
    cmd = [sys.executable, "-m", "neuralsvb_torch.data.binarize", "--config", cfg,
           "--hparams", f"device={device}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"binarize {cfg} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    m = re.search(r"^\| binarize summary: (\{.*\})$", proc.stdout, re.M)
    if m is None:
        raise RuntimeError(f"no binarize summary in the output:\n{proc.stdout[-4000:]}")
    return wall, json.loads(m.group(1))


def _ab_binarize_pass(checkout, cfg, binary_dir):
    cmd = [sys.executable, "-m", "neuralsvb_torch.data.binarize", "--config", cfg,
           "--hparams", f"device=cuda,binary_data_dir={binary_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"para pass in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("| binarize summary: "))
    return wall, json.loads(line[len("| binarize summary: "):])


def _ab_handoff_ms(sh, th, repeats=20):
    """Median ms of the old and new hand-off of one pair's cost, and of the DP."""
    import torch
    from neuralsvb_torch.native import dtw_align_native
    from neuralsvb_torch.ops import dtw
    from neuralsvb_torch.ops.chi2 import chi2_dist
    a = torch.as_tensor(sh, dtype=torch.float32, device="cuda")
    b = torch.as_tensor(th, dtype=torch.float32, device="cuda")

    def old():
        return chi2_dist(a, b).T.contiguous().cpu().numpy()

    def new():
        return dtw._to_host(chi2_dist(b, a))

    if not (old() == new()).all():
        raise AssertionError("the two hand-offs give different costs")
    cost = new()
    times = {"old": [], "new": [], "dp": []}
    for _ in range(repeats):
        for name, fn in (("old", old), ("new", new), ("new", new), ("old", old),
                         ("dp", lambda: dtw_align_native(cost))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def binarize_ab(argv):
    """The binarize path's DTW stage on one NVIDIA card, this checkout against an
    earlier one, in one run.

    Run from the root of a checkout on a machine with a CUDA card (not part of
    the smoke run)::

        python3 chip_smoke.py --binarize-ab --other DIR [--out FILE]

    ``DIR`` is another checkout of the repository (for example the parent
    commit, unpacked with ``git archive`` into a git-ignored directory). It writes
    phase 6's 8 synthetic sung pairs, runs the
    speaker-embedding pass once, builds each checkout's libraries, then runs
    the para pass of ``python -m neuralsvb_torch.data.binarize`` on the card
    six times, in turns (other, this, this, other, other, this), each from its
    own checkout, and reads each pass's ``| binarize summary:`` line (seconds per stage,
    chi-square launches, wall). Then, in this process, it times the χ² cost's
    hand-off to the host for the largest pair's histograms: the earlier path
    (``chi2_dist(source, target)``, a transpose on the card, a pageable copy)
    against this checkout's (``chi2_dist(target, source)`` into pinned memory),
    and the host DP that reads the cost: medians over 20 repeats, each ending
    in a synchronized host array.

    Prints one JSON line per result and writes them all to FILE."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py --binarize-ab")
    ap.add_argument("--other", required=True, help="the earlier checkout")
    ap.add_argument("--out", default=str(Path(REPO) / "build" / "binarize_ab.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("--binarize-ab needs a CUDA card")
    other = Path(args.other).resolve()
    root = Path(REPO) / "build" / "binarize_ab"
    shutil.rmtree(root, ignore_errors=True)
    cfgs = binarize_configs(str(root), write_sung_pairs(str(root)))
    rows = []

    def emit(kind, **kw):
        rows.append({"kind": kind, **kw})
        print(json.dumps(rows[-1]), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit("environment", device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    wall, emb = run_binarize(cfgs["save_emb_torch"], "cuda")
    emit("save_emb", wall_s=wall, summary=emb)
    build = ("from neuralsvb_torch import native; from neuralsvb_torch.ops import chi2; "
             "chi2.LIBRARY.get(); native.LIBRARY.get()")
    for checkout in (other, Path(REPO)):  # kernel builds stay out of the timed passes
        subprocess.run([sys.executable, "-c", build], cwd=checkout, check=True, timeout=600)
    turns = ("other", "this", "this", "other", "other", "this")
    for i, name in enumerate(turns):
        checkout = other if name == "other" else Path(REPO)
        wall, summary = _ab_binarize_pass(checkout, cfgs["para_bin_torch"], root / f"binary_{i}")
        emit("para_pass", checkout=name, turn=i, wall_s=wall,
             dtw_align_s=summary["stage_seconds"]["dtw_align"],
             chi2_dist_launches=summary["chi2_dist_launches"], summary=summary)

    from neuralsvb_torch.ops.dtw import f0_shape_histogram
    from neuralsvb_torch.data.indexed_dataset import IndexedDataset
    items = []
    for prefix in ("train", "test"):
        ds = IndexedDataset(str(root / "binary_1" / prefix))
        items += [ds[i] for i in range(len(ds))]
    it = max(items, key=lambda x: len(x["f0"]) * len(x["prof_f0"]))
    S, T = len(it["f0"]), len(it["prof_f0"])
    sh = f0_shape_histogram(it["f0"], enhanced=True)
    th = f0_shape_histogram(it["prof_f0"], enhanced=True, scale_factor=T / S)
    emit("handoff", item=it["item_name"], S=S, T=T, cost_bytes=4 * S * T,
         median_ms=_ab_handoff_ms(sh, th))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


def read_split(binary_dir, prefix):
    from neuralsvb_torch.data.indexed_dataset import IndexedDataset
    ds = IndexedDataset(os.path.join(binary_dir, prefix))
    return [ds[i] for i in range(len(ds))]


def phase_binarize(device="cuda"):
    """Both CLI passes on ``device``; returns (configs, chi2 launches)."""
    import numpy as np
    from neuralsvb_torch.data.datasets import MultiSpkEmbDataset
    from neuralsvb_torch.hparams import set_hparams
    root = os.path.join(WORK, "binarize")
    cfgs = binarize_configs(root, write_sung_pairs(root))
    wall_emb, emb = run_binarize(cfgs["save_emb_torch"], device)
    wall_para, para = run_binarize(cfgs["para_bin_torch"], device)
    n_items, frames = 0, []
    for prefix in ("train", "test"):
        for it in read_split(os.path.join(root, "binary"), prefix):
            missing = [k for k in PAIR_KEYS if k not in it]
            al, T_a, T_p = it["a2p_f0_alignment"], len(it["f0"]), len(it["prof_f0"])
            if (missing or it["mel"].shape != (T_a, 80)
                    or it["multi_spk_emb"].shape != (5, 256) or al.shape != (T_p,)
                    or al.min() < 0 or al.max() >= T_a or (np.diff(al[1:]) < 0).any()):
                raise AssertionError(f"{it['item_name']}: missing {missing}, mel "
                                     f"{it['mel'].shape}, multi_spk_emb "
                                     f"{it['multi_spk_emb'].shape}, alignment "
                                     f"{al.shape} in [{al.min()}, {al.max()}]")
            n_items += 1
            frames.append((T_a, T_p))
    binarized = sum(para["items"].values())  # valid repeats test, as in JAX
    launches = para["chi2_dist_launches"]
    hp = set_hparams(config=cfgs["para_bin_torch"], print_hparams=False,
                     global_hparams=False)
    ds = MultiSpkEmbDataset("test", hp=hp)
    batch = ds.collater([ds[i] for i in range(len(ds))])
    emit("binarize", device=device, pairs=n_items, items_binarized=binarized,
         frames_amateur_prof=frames, save_emb_wall_s=wall_emb,
         para_wall_s=wall_para, save_emb_summary=emb, para_summary=para,
         chi2_dist_launches=launches, collated_mels=list(batch["mels"].shape))
    if n_items != len(AMATEUR_SECONDS) or para["items"]["test"] != 4:
        raise AssertionError(f"{n_items} pairs packed, {para['items']}")
    if device == "cuda" and launches != binarized:
        raise AssertionError(f"chi2 launches {launches} != items {binarized}")
    if batch["multi_spk_emb"].shape != (4, 5, 256):
        raise AssertionError(f"collated multi_spk_emb {batch['multi_spk_emb'].shape}")
    return cfgs, launches


def phase_binarize_card_vs_cpu(cfgs, device="cuda"):
    """The test split again on the CPU, in this process, against the
    ``device`` run's items."""
    import numpy as np
    import torch
    from neuralsvb_torch.data import binarizer as B
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.native import dtw_align_native
    from neuralsvb_torch.ops.chi2 import chi2_dist, chi2_dist_plain
    from neuralsvb_torch.ops.dtw import f0_shape_histogram
    root = os.path.join(WORK, "binarize")
    over = dict(device="cpu", binary_data_dir=os.path.join(root, "binary_cpu"),
                spk_emb_data_dir=os.path.join(root, "spk_emb_cpu"))
    os.makedirs(over["binary_data_dir"])
    for name, cls in (("save_emb_torch", B.SaveSpkEmb),
                      ("para_bin_torch", B.PopBuTFyENSpkEMBinarizer)):
        hp = set_hparams(config=cfgs[name], print_hparams=False, global_hparams=False)
        with hparams_scope(hp, **over):
            b = cls()
            b.load_meta_data()
            b.spk_map = b.build_spk_map()
            b.process_data("test")
    card = read_split(os.path.join(root, "binary"), "test")
    cpu = read_split(over["binary_data_dir"], "test")
    rows = []
    for c, h in zip(card, cpu):
        if c["item_name"] != h["item_name"]:
            raise AssertionError(f"{c['item_name']} != {h['item_name']}")
        sh = f0_shape_histogram(c["f0"], enhanced=True)
        th = f0_shape_histogram(c["prof_f0"], enhanced=True,
                                scale_factor=len(c["prof_f0"]) / len(c["f0"]))
        a = torch.as_tensor(sh, dtype=torch.float32)
        b = torch.as_tensor(th, dtype=torch.float32)
        # the DP's [T, S] cost, as the aligners compute it
        cost_card = chi2_dist(b.to(device), a.to(device)).cpu().numpy()
        cost_cpu = chi2_dist_plain(b, a).numpy()
        total_card = dtw_align_native(cost_card)[1]
        total_cpu = dtw_align_native(cost_cpu)[1]
        f0_ok = np.abs(np.concatenate([c["f0"] - h["f0"], c["prof_f0"] - h["prof_f0"]])) <= 1.0
        rows.append(dict(
            item=c["item_name"], frames=len(c["f0"]), prof_frames=len(c["prof_f0"]),
            mel_max_abs_err=float(max(np.abs(c["mel"] - h["mel"]).max(),
                                      np.abs(c["prof_mel"] - h["prof_mel"]).max())),
            f0_frames_within_1hz=int(f0_ok.sum()), f0_frames=int(f0_ok.size),
            align_frames_equal=int((c["a2p_f0_alignment"] == h["a2p_f0_alignment"]).sum()),
            align_frames=len(c["a2p_f0_alignment"]),
            dtw_total_card=total_card, dtw_total_cpu=total_cpu,
            dtw_total_rel_err=abs(total_card - total_cpu) / abs(total_cpu),
            spk_emb_max_abs_err=float(np.abs(c["multi_spk_emb"][0]
                                             - h["multi_spk_emb"][0]).max())))
    ok = len(rows) == 4 and all(
        r["mel_max_abs_err"] <= 1e-4 and r["f0_frames_within_1hz"] >= 0.99 * r["f0_frames"]
        and r["align_frames_equal"] >= 0.99 * r["align_frames"]
        and r["dtw_total_rel_err"] <= 1e-4 and r["spk_emb_max_abs_err"] <= 1e-4
        for r in rows)
    emit("binarize_card_vs_cpu", items=rows, ok=ok)
    if not ok:
        raise AssertionError(f"binarize card vs CPU: {rows}")


TRAIN_STEPS, TRAIN_PHASE2, TRAIN_RESUME = 8, 4, 10
PHASE_KEYS = {"2": {"a2a_kl", "ssima2a", "l1a2a", "p2p_kl", "ssimp2p", "l1p2p", "a2a_a",
                    "p2p_a", "a2a_r", "a2a_f", "p2p_r", "p2p_f", "lr_0", "lr_1"},
              "3": {"a2a_kl", "ssima2p", "l1a2p", "a2p_mle", "a2p_a", "lr_2"}}


FLAGSHIP = "vae_global_mle_eng_torch.yaml"


def train_config(voc_dir, device="cuda", recipe=FLAGSHIP, name="train.yaml", **over):
    """A PopBuTFy SVB recipe (the flagship unless ``recipe`` names another)
    at full width on phase 6's packed splits, written to ``name``."""
    import yaml
    cfg = os.path.join(WORK, name)
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(REPO, "egs/datasets/audio/PopBuTFy", recipe)],
            "binary_data_dir": os.path.join(WORK, "binarize", "binary"),
            "vocoder_ckpt": voc_dir, "device": device, "pretrain_asr_ckpt": "",
            "hidden_size": 256, "latent_size": 128, "fvae_enc_dec_hidden": 192,
            "fvae_kernel_size": 5, "fvae_enc_n_layers": 8, "fvae_dec_n_layers": 4,
            "asr_enc_layers": 2, "disc_win_num": 3, "mel_disc_hidden_size": 128,
            "phase_2_steps": TRAIN_PHASE2, "max_updates": TRAIN_STEPS,
            "val_check_interval": 4, "valid_infer_interval": 4,
            "num_sanity_val_steps": 1, "num_valid_plots": 1, "tb_log_interval": 1},
            **over), f)
    return cfg


def run_train_cli(cfg, work, *args, hp="", in_process=False):
    """``python -m neuralsvb_torch.tasks.run --config cfg [--infer] --hparams
    work_dir=work...`` -> (its stdout, wall s). With ``in_process`` the same
    entry (``tasks.run.run_task``) runs in this process with its stdout
    captured: a resume or a render after a process of the same recipe, which
    spares an interpreter's and a card context's start-up (about 6 s)."""
    t0 = time.perf_counter()
    if in_process:
        import contextlib
        import gc
        import io
        import torch
        from neuralsvb_torch.hparams import hparams_scope, set_hparams
        from neuralsvb_torch.tasks.run import run_task
        h = set_hparams(config=cfg, hparams_str=f"work_dir={work}{hp}", print_hparams=False,
                        global_hparams=False)
        h["infer"] = "--infer" in args
        precision = torch.get_float32_matmul_precision()  # bf16 recipes set it
        out = io.StringIO()
        try:
            with hparams_scope(h), contextlib.redirect_stdout(out):
                run_task()
        finally:
            torch.set_float32_matmul_precision(precision)
            gc.collect()
            torch.cuda.empty_cache()
        return out.getvalue(), time.perf_counter() - t0
    cmd = [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config", cfg, *args,
           "--hparams", f"work_dir={work}{hp}"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args) or 'train'} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def summary_of(stdout, what):
    m = re.search(rf"^\| {what} summary: (\{{.*\}})$", stdout, re.M)
    if m is None:
        raise RuntimeError(f"no {what} summary in the output:\n{stdout[-4000:]}")
    return json.loads(m.group(1))


def changed(a, b):
    import torch
    return {k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())}


def phase_train(voc, device="cuda"):
    """Train 8 steps across phases 2 and 3, resume to 10, render; returns
    the train run's kernel launches."""
    import math
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    cfg = train_config(os.path.join(WORK, "voc"), device=device)
    work = os.path.join(WORK, "train_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
    bad = []
    for step, logs in steps.items():
        phase = "2" if step - 1 <= TRAIN_PHASE2 else "3"
        if not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {step}: non-finite {logs}")
        missing = PHASE_KEYS[phase] - set(logs)
        if step > 1 and missing:  # the discriminator starts after step 0
            bad.append(f"step {step} (phase {phase}) lacks {sorted(missing)}")
    if sorted(steps) != list(range(1, TRAIN_STEPS + 1)):
        bad.append(f"logged steps {sorted(steps)}")

    def load(step):
        return torch.load(os.path.join(work, f"model_ckpt_steps_{step}.ckpt"),
                          map_location="cpu", weights_only=True)["state_dict"]
    # steps 0-3 (phase 2) end in the step-4 checkpoint, steps 8-9 (phase 3)
    # run between the step-8 and step-10 ones
    c4, c8 = load(TRAIN_PHASE2), load(TRAIN_STEPS)
    hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    with hparams_scope(hp):
        init = SVBVAEMleTask()
        init.build_model()
        init.build_train()
    phase2 = changed(init.model.state_dict(), c4["model"])
    audio = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(work, "lightning_logs", "version_0", "audio", "*.wav")))
    calls = s["vocoder_calls"]
    stages = len(voc["upsample_rates"])
    on_card = device == "cuda"  # CPU tensors take the plain cluster
    want = {"resblock_conv1d_bf16_launches": 18 * stages * calls * on_card,
            "lrelu_bf16_launches": stages * calls * on_card, "resblock_conv1d_launches": 0}
    launches = {k: s[k] for k in want}

    # a fresh process restores the checkpoint (the later recipes resume in
    # this one)
    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={TRAIN_RESUME}")
    rs = summary_of(resumed, "train")
    c10 = load(TRAIN_RESUME)
    phase3 = changed(c8["model"], c10["model"])
    invariants = {
        "phase2_changes_generator": bool(phase2),
        "phase2_keeps_asr_and_map": not any(
            k.startswith(("vc_asr.", "z_mapping_function.")) for k in phase2),
        "phase2_changes_disc": bool(changed(init.mel_disc.state_dict(), c4["mel_disc"])),
        "phase3_changes_only_map": bool(phase3) and all(
            k.startswith("z_mapping_function.") for k in phase3),
        "phase3_keeps_disc": not changed(c8["mel_disc"], c10["mel_disc"]),
        "asr_never_changes": not any(k.startswith("vc_asr.") for k in changed(
            init.model.state_dict(), c10["model"]))}
    infer, wall_infer = run_train_cli(cfg, work, "--infer", in_process=True)
    isum = summary_of(infer, "infer")
    gen_dir = os.path.join(work, f"generated_{TRAIN_RESUME}_", "wavs")
    wavs = {k: len(glob.glob(os.path.join(gen_dir, f"{k}_wavout", "*.wav")))
            for k in ("gt_a", "gt_p", "a2a", "p2p", "a2p")}
    n_test = 4
    ok = (not bad and all(invariants.values()) and calls == 3 + 3 + 4
          and len(audio) == calls and launches == want
          and (rs["start_step"], rs["end_step"]) == (TRAIN_STEPS, TRAIN_RESUME)
          and f"model_ckpt_steps_{TRAIN_STEPS}.ckpt" in resumed
          and all(n == n_test for n in wavs.values()))
    emit("train", ok=ok, wall_s=wall, resume_wall_s=wall_resume,
         infer_in_process_wall_s=wall_infer,
         summary=s, resume_summary=rs, infer_rtf=isum["rtf"], invariants=invariants,
         problems=bad, validation_wavs=audio, launches=launches, expected_launches=want,
         wav_tree=wavs, last_step_losses=steps.get(TRAIN_STEPS))
    print(f"| train summary: {json.dumps(s)}", flush=True)
    if not ok:
        raise AssertionError(f"train phase failed: {bad} {invariants} {launches} "
                             f"{want} {audio} {wavs} {rs}")
    return launches


def train_step_runs(task_cls, dtypes, devices=("cpu", "cuda"), sides=("cpu", "card"),
                    deltas=None, states=None, map_from=None, names=None, on_task=None,
                    **over):
    """One gen+disc step and one map step of ``task_cls`` on the CPU and on
    the card, per dtype, from the same seeded float32 weights, at zero noise
    with pinned discriminator windows and the same dropout masks (drawn on
    the CPU); the four train items cropped to 640 frames. Returns ({(side,
    dtype): (losses, gradients by group)}, the batch). With a dict
    ``deltas``, each run's parameter change per group (after its
    optimizer's step minus before) lands in ``deltas[side, dtype]``. With a
    dict ``states``, the model's and the discriminator's state after the
    gen+disc step lands in ``states[side, dtype]``; ``map_from``, such a
    state, is loaded (cast to the run's dtype) before the map step, so the
    map step starts from another run's parameters. A dict ``names`` gets
    each group's parameter names, in the gradients' order, and under
    ``"batchnorm"`` the names of the model's BatchNorm modules.
    ``on_task(task)`` runs after each task is built, before its steps."""
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    runs = {}
    for dtype in dtypes:
        for side, dev in zip(sides, devices):
            cfg = train_config(os.path.join(WORK, "voc"), device=dev, max_frames=640,
                               zero_noise=True, ds_workers=0, **over)
            hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
            with hparams_scope(hp):
                task = task_cls()
                task.build_model()
                task.build_train()
                task.model.to(dtype)
                task.mel_disc.to(dtype)
                task.rand_device = torch.device("cpu")  # the same dropout masks on all
                task.disc_start_frames_wins = [100, 200, 300]
                if on_task is not None:
                    on_task(task)
                grads, before, params = {}, {}, {}
                ids = {id(p): n for m in (task.model, task.mel_disc)
                       for n, p in m.named_parameters()}
                if names is not None:
                    names["batchnorm"] = {n for n, m in task.model.named_modules()
                                          if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}

                def hook(group, ps, grads=grads, before=before, params=params):
                    grads[group] = [p.grad.detach().cpu().double().clone() for p in ps]
                    if names is not None:
                        names[group] = [ids[id(p)] for p in ps]
                    if deltas is not None:
                        before[group] = [p.detach().cpu().double().clone() for p in ps]
                        params[group] = ps
                task.grad_hook = hook
                task.train_dataloader()
                ds = task._train_ds
                batch = ds.collater([ds[i] for i in range(len(ds))])
                logs = {}
                torch.set_default_dtype(dtype)
                try:
                    for step, idx in ((1, 0), (1, 1), (TRAIN_PHASE2 + 1, 2)):
                        if idx == 2 and states is not None:
                            states[side, dtype] = {
                                part: {k: v.detach().cpu().clone()
                                       for k, v in m.state_dict().items()}
                                for part, m in (("model", task.model),
                                                ("disc", task.mel_disc))}
                        if idx == 2 and map_from is not None:
                            task.model.load_state_dict(map_from["model"])
                            task.mel_disc.load_state_dict(map_from["disc"])
                        logs.update({f"{idx}/{k}": float(torch.as_tensor(v).detach())
                                     for k, v in task.training_step(batch, step, idx)[1].items()})
                finally:
                    torch.set_default_dtype(torch.float32)
                runs[side, dtype] = logs, grads
                if deltas is not None:
                    deltas[side, dtype] = {
                        g: [p.detach().cpu().double() - b for p, b in zip(params[g], before[g])]
                        for g in params}
    return runs, batch


def loss_rel(a, b):
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}


def grad_scales(ref):
    """Per tensor max(max|g|, 1e-3 of the group's largest)."""
    big = max(float(t.abs().max()) for t in ref)
    return [max(float(t.abs().max()), 1e-3 * big) for t in ref]


def grads_over_scale(a, b, scales):
    return max(float((x - y).abs().max()) / s for x, y, s in zip(a, b, scales))


def after_last_batchnorm(names):
    """The slice of the map's gradients from its last BatchNorm on (that
    norm's scale and shift, then the output conv), by ``train_step_runs``'
    ``names``: the tensors that no BatchNorm's backward lies between and
    the loss."""
    mods = [n.rsplit(".", 1)[0] for n in names["map"]]
    last = max(i for i, m in enumerate(mods) if m in names["batchnorm"])
    return slice(mods.index(mods[last]), None)


class NormStatsCheck:
    """Forward hooks on every training-mode BatchNorm of a task's model and
    discriminator: each call's output against the same normalisation in
    float64 of the same input (flax's batch statistics, the module's scale
    and shift as the call saw them). ``worst`` maps a module to its largest
    max |out - ref| / max |ref| over its calls. bf16 rounds the output
    (2^-9 relative); statistics taken in bf16 instead of float32 are off by
    2^-9 of E[x^2], which swamps the variance of a channel whose rows are
    nearly equal, as the latent map's four global latents are."""

    def __init__(self, task):
        import torch
        self.worst = {}
        self.handles = [
            m.register_forward_hook(self._hook(f"{part}.{n}"))
            for part, root in (("model", task.model), ("disc", task.mel_disc))
            for n, m in root.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]

    def _hook(self, name):
        import torch

        def hook(mod, args, out):
            if not mod.training:
                return
            with torch.no_grad():
                x, y = args[0].double(), out.double()
                shape = [1, -1] + [1] * (x.dim() - 2)
                dims = [0] + list(range(2, x.dim()))
                mean = x.mean(dims).view(shape)
                var = ((x * x).mean(dims).view(shape) - mean * mean).clamp_min(0.0)
                ref = ((x - mean) * torch.rsqrt(var + mod.eps) * mod.weight.double().view(shape)
                       + mod.bias.double().view(shape))
                err = float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
            self.worst[name] = max(self.worst.get(name, 0.0), err)
        return hook

    def close(self):
        for h in self.handles:
            h.remove()


def grad_cosine(a, b):
    """The cosine of two lists of tensors, taken as one vector each."""
    dot = sum(float((x * y).sum()) for x, y in zip(a, b))
    na = math.sqrt(sum(float((x * x).sum()) for x in a))
    nb = math.sqrt(sum(float((y * y).sum()) for y in b))
    return dot / max(na * nb, 1e-300)


def phase_train_card_vs_cpu(devices=("cpu", "cuda")):
    """One gen+disc step and one map step on the card and on the CPU, in
    float32 and in float64 from the same float32 weights; returns the row,
    the runs, the CPU float64 run's parameter changes and its state before
    the map step (phase 22 holds the bf16 steps against them)."""
    import torch
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    t0 = time.perf_counter()
    deltas, states = {}, {}
    runs, batch = train_step_runs(SVBVAEMleTask, (torch.float32, torch.float64), devices,
                                  deltas=deltas, states=states)
    f32, f64 = torch.float32, torch.float64
    rel32 = loss_rel(runs["card", f32][0], runs["cpu", f32][0])
    rel64 = loss_rel(runs["card", f64][0], runs["cpu", f64][0])
    ok = (runs["card", f32][0].keys() == runs["cpu", f32][0].keys()
          and max(rel32.values()) <= 1e-4 and max(rel64.values()) <= 1e-4)
    groups = {}
    for group in ("gen", "disc", "map"):
        scales = grad_scales(runs["cpu", f64][1][group])

        def worst(a, b):
            return grads_over_scale(a, b, scales)
        g = {(side, dt): runs[side, dt][1][group] for side in ("cpu", "card") for dt in (f32, f64)}
        groups[group] = dict(
            card_vs_cpu_f64=worst(g["card", f64], g["cpu", f64]),
            card_vs_cpu_f32=worst(g["card", f32], g["cpu", f32]),
            card_f32_vs_f64=worst(g["card", f32], g["cpu", f64]),
            cpu_f32_vs_f64=worst(g["cpu", f32], g["cpu", f64]))
        ok = ok and groups[group]["card_vs_cpu_f64"] <= 1e-3
    row = dict(ok=ok, frames=640, batch=len(batch["id"]), max_loss_rel_err_f32=max(rel32.values()),
               max_loss_rel_err_f64=max(rel64.values()), tol_loss=1e-4, tol_grad_f64=1e-3,
               grads_over_scale=groups, seconds=time.perf_counter() - t0,
               loss_rel_err_f32=rel32, losses_cpu_f32=runs["cpu", f32][0])
    emit("train_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"train card vs CPU: {rel32} {rel64} {groups}")
    return row, runs, deltas["cpu", torch.float64], states["cpu", torch.float64]


VOC_STEPS, VOC_RESUME, VOC_DISC_START, VOC_VAL_EVERY = 4, 6, 1, 4
VOC_VALID_ITEMS = 4  # the Male6 pairs' amateur sides, one per validation batch
VOC_BATCH, VOC_TIMED_STEPS = 16, 5  # the recipe's max_sentences; warm steps timed
VOC_LOSS_RATIO = 1.0  # phase 11: |card_bf16 - cpu_bf16| / |cpu_bf16 - cpu_f32| per loss
VOC_GEN_KEYS = {"mel", "a_p", "a_s", "lr_0"}
VOC_DISC_KEYS = {"r_p", "f_p", "r_s", "f_s", "lr_1"}
def profiled_step(prof, wall_s, median_s):
    """A profiled step's device time: the kernels' durations summed
    (``kernel_ms``, by kind) and their intervals merged (``merged_busy_ms``,
    per device), each over the profiled step's wall and the unprofiled
    median. On one stream the two agree; a gap shows overlapping streams."""
    from neuralsvb_torch.utils.profiling import device_busy, kernel_split
    kinds, ops = kernel_split(prof)
    busy = sum(v[0] for v in kinds.values())
    merged = {k: v * 1e3 for k, v in device_busy(prof).items()}
    merged_ms = sum(merged.values())
    return {"wall_ms": wall_s * 1e3, "kernel_ms": busy, "device_ops": ops,
            "busy_share_of_wall": busy / (wall_s * 1e3),
            "busy_share_of_median": busy / (median_s * 1e3),
            "merged_busy_ms": merged,
            "merged_busy_share_of_wall": merged_ms / (wall_s * 1e3),
            "merged_busy_share_of_median": merged_ms / (median_s * 1e3),
            "by_kind_ms": {k: {"ms": v[0], "launches": v[1], "share": v[0] / busy}
                           for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][0])}}


def vocoder_configs(device="cuda", **over):
    """The vocoder's binarize pass (``vocoder_bin_torch.yaml`` over phase
    6's wavs and speaker embeddings, waveforms kept) and its training recipe
    (``hifigan_nsf_torch.yaml``, full width) on that split."""
    import yaml
    root = os.path.join(WORK, "binarize")
    binary = os.path.join(WORK, "vocoder_binary")
    bin_cfg, cfg = (os.path.join(WORK, f) for f in ("vocoder_bin.yaml", "vocoder_train.yaml"))
    with open(bin_cfg, "w") as f:
        yaml.safe_dump({
            "base_config": [os.path.join(
                REPO, "egs/datasets/audio/PopBuTFy/vocoder_bin_torch.yaml")],
            "processed_data_dir": os.path.join(root, "processed"), "binary_data_dir": binary,
            "spk_emb_data_dir": os.path.join(root, "spk_emb"),
            "test_prefixes": ["Male6#singing#"], "ge2e_ckpt": "", "ds_workers": 1}, f)
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(
                REPO, "egs/datasets/audio/PopBuTFy/hifigan_nsf_torch.yaml")],
            "binary_data_dir": binary, "device": device, "max_updates": VOC_STEPS,
            "disc_start_steps": VOC_DISC_START, "val_check_interval": VOC_VAL_EVERY,
            "tb_log_interval": 1}, **over), f)
    return bin_cfg, cfg


def phase_vocoder_train(device="cuda"):
    """Binarize with waveforms, train the vocoder, resume, render the SVB
    test split through it; returns (the training run's cluster-kernel
    launches, the binarize pass's χ² launches, the training config)."""
    import math
    import numpy as np
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask
    bin_cfg, cfg = vocoder_configs(device)
    wall_bin, bsum = run_binarize(bin_cfg, device)
    binary = os.path.join(WORK, "vocoder_binary")
    bad = [f"{it['item_name']}: wav {it['wav'].shape} for {len(it['mel'])} frames"
           for prefix in ("train", "valid") for it in read_split(binary, prefix)
           if it["wav"].shape != (128 * len(it["mel"]),)]
    binarized = sum(bsum["items"].values())
    chi2_launches = bsum["chi2_dist_launches"]
    if device == "cuda" and chi2_launches != binarized:
        bad.append(f"chi2 launches {chi2_launches} != items {binarized}")

    work = os.path.join(WORK, "vocoder_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
    for n, logs in steps.items():  # "step n" logs step n - 1
        want = VOC_GEN_KEYS | (VOC_DISC_KEYS if n - 1 > VOC_DISC_START else set())
        if set(logs) - {"total_loss_0", "total_loss_1"} != want:
            bad.append(f"step {n} logs {sorted(logs)}")
        if not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {n}: non-finite {logs}")
    if sorted(steps) != list(range(1, VOC_STEPS + 1)):
        bad.append(f"logged steps {sorted(steps)}")
    validations = out.count("| Valid results:")
    calls = s["vocoder_calls"]
    on_card = device == "cuda"  # CPU tensors take the plain cluster
    hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    stages = len(hp["upsample_rates"])
    want = {"resblock_conv1d_bf16_launches": 18 * stages * calls * on_card,
            "lrelu_bf16_launches": stages * calls * on_card, "resblock_conv1d_launches": 0}
    launches = {k: s[k] for k in want}
    if calls != VOC_STEPS + VOC_VALID_ITEMS * validations or launches != want:
        bad.append(f"{calls} generator calls, {validations} validations, launches "
                   f"{launches} != {want}")

    with hparams_scope(hp):
        init = HifiGanTask()
        init.build_model()
    trained = torch.load(os.path.join(work, f"model_ckpt_steps_{VOC_STEPS}.ckpt"),
                         map_location="cpu", weights_only=True)["state_dict"]
    changed_groups = {name: bool(changed(m.state_dict(), trained[name])) for name, m in
                      (("model_gen", init.model), ("mpd", init.mpd), ("msd", init.msd))}
    if not all(changed_groups.values()):
        bad.append(f"unchanged parameter groups: {changed_groups}")

    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={VOC_RESUME}",
                                         in_process=True)
    rs = summary_of(resumed, "train")
    if (rs["start_step"], rs["end_step"]) != (VOC_STEPS, VOC_RESUME) \
            or f"model_ckpt_steps_{VOC_STEPS}.ckpt" not in resumed:
        bad.append(f"resume: {rs['start_step']} -> {rs['end_step']}")

    # the SVB test split rendered through the trained vocoder
    svb_cfg = train_config(os.path.join(WORK, "voc"), device=device)
    infer, wall_infer = run_train_cli(svb_cfg, os.path.join(WORK, "train_work"), "--infer",
                                      hp=f",vocoder_ckpt={work},gen_dir_name=trained_vocoder",
                                      in_process=True)
    if f"| Loaded HifiGAN weights from {work}" not in infer:
        bad.append("--infer did not load the trained vocoder")
    wavs = glob.glob(os.path.join(WORK, "train_work", f"generated_{TRAIN_RESUME}_trained_vocoder",
                                  "wavs", "*_wavout", "*.wav"))
    rms = []
    for wf in wavs:
        with wave.open(wf) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.float64)
        rms.append(float(np.sqrt(np.mean(pcm ** 2))))
    if len(wavs) != 5 * 4 or min(rms) < 1.0:
        bad.append(f"{len(wavs)} wavs rendered, rms {rms}")
    emit("vocoder_train", ok=not bad, problems=bad, binarize_wall_s=wall_bin,
         binarize_summary=bsum, wall_s=wall, resume_in_process_wall_s=wall_resume,
         infer_in_process_wall_s=wall_infer, summary=s, resume_summary=rs, validations=validations,
         generator_calls=calls, launches=launches, expected_launches=want,
         changed_groups=changed_groups, rendered_wavs=len(wavs), min_rms_int16=min(rms or [0]),
         last_step_losses=steps.get(VOC_STEPS))
    print(f"| train summary: {json.dumps(s)}", flush=True)
    if bad:
        raise AssertionError(f"vocoder train phase failed: {bad}")
    return launches, chi2_launches, cfg


def vocoder_step_parts(task, batch, spec):
    """Device time of a step's parts, each alone between CUDA events
    (median of 10): the cluster backward's kernels at the three stage
    shapes (and, as a yardstick, the plain f32 recompute + autograd the
    kernels replaced), the discriminators (the generator step's pass over
    y_hat with its input gradient, the discriminator step's real and fake
    passes with their weight gradients) and the log-mel L1 with its input
    gradient."""
    import torch
    from neuralsvb_torch.models import hifigan as hf
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.tasks.base_task import no_grad_for
    from neuralsvb_torch.utils.profiling import median_ms
    gen = torch.Generator().manual_seed(3)
    b = task._prep_batch(batch)
    B, L = b["wavs"].shape
    parts = {}
    bwd = plain = 0.0
    for Bs, C, T in TRAIN_SHAPES:
        x = torch.randn(Bs, C, T, generator=gen).cuda().requires_grad_(True)
        w = [t.requires_grad_(True) for t in random_cluster(C, spec, gen, "cuda")]
        g = torch.randn(Bs, C, T, generator=gen).cuda()
        bwd += median_ms(lambda: fr.resblock_cluster_backward_cuda(x, w, spec, g), n=10)
        plain += median_ms(lambda: torch.autograd.grad(
            fr.resblock_cluster_plain(x, w, spec), [x] + w, g), n=10)
        del x, w, g
    parts["cluster_backward_kernels"] = bwd
    parts["cluster_backward_plain_f32_yardstick"] = plain
    y_hat = (0.3 * torch.randn(B, L, generator=gen)).cuda().requires_grad_(True)

    def disc_gen():
        with no_grad_for(task.disc_params):
            loss = hf.generator_loss(task.mpd(y_hat)[0]) + hf.generator_loss(task.msd(y_hat)[0])
            torch.autograd.grad(loss, y_hat)

    def disc_disc():
        task.opt_disc.zero_grad(set_to_none=True)
        fake = y_hat.detach()
        rp, fp = hf.discriminator_loss(task.mpd(b["wavs"])[0], task.mpd(fake)[0])
        rs, fs = hf.discriminator_loss(task.msd(b["wavs"])[0], task.msd(fake)[0])
        (rp + fp + rs + fs).backward()

    def log_mel_l1():
        ref = task._mel_fn(b["wavs"])
        torch.autograd.grad((task._mel_fn(y_hat) - ref).abs().mean(), y_hat)

    parts["discriminators_gen_step"] = median_ms(disc_gen, n=10)
    parts["discriminators_disc_step"] = median_ms(disc_disc, n=10)
    parts["log_mel_l1"] = median_ms(log_mel_l1, n=10)
    task.opt_disc.zero_grad(set_to_none=True)
    return parts


def phase_vocoder_step_time(cfg, train_rows, spec):
    """Warm generator + discriminator steps of the recipe at B = 16 x 8192
    on synthetic crops, in this process: first step, median/min/max of the
    warm ones, peak memory, kernel launches per step, one step under
    ``torch.profiler`` (kernel time by kind, busy share) and the parts'
    device times (``vocoder_step_parts``); the cluster forward's is phase
    3's at the training shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsvb_torch.data.synthetic import synthetic_crops
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask
    hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
    with hparams_scope(hp, disc_start_steps=0) as h:
        task = HifiGanTask()
        task.build_model()
        task.build_train()
        batch = synthetic_crops(VOC_BATCH, h)

        def step(i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            task.training_step(batch, i, 0)
            task.training_step(batch, i, 1)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        first = step(1)
        for c in fr.KERNEL_COUNTERS:
            c.launches = 0
        warm = [step(2 + i) for i in range(VOC_TIMED_STEPS)]
        per_step = {f"{c.__name__}_launches": c.launches / VOC_TIMED_STEPS
                    for c in fr.KERNEL_COUNTERS}
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = step(2 + VOC_TIMED_STEPS)
        parts = vocoder_step_parts(task, batch, spec)
    med = statistics.median(warm)
    parts["cluster_forward_bf16_kernel"] = sum(r["kernel_ms"] for r in train_rows)
    row = dict(batch=[VOC_BATCH, batch["wavs"].shape[1]], first_step_s=first,
               warm_steps_s=warm, median_s=med, min_s=min(warm), max_s=max(warm),
               max_memory_allocated=peak, launches_per_step=per_step,
               profiled_step=profiled_step(prof, wall, med),
               parts_ms=parts, parts_share_of_median={k: v / (med * 1e3)
                                                      for k, v in parts.items()})
    emit("vocoder_step_time", **row)
    want = {"resblock_conv1d_bf16_launches": 54, "lrelu_bf16_launches": 3,
            "resblock_conv1d_launches": 0,
            "resblock_cluster_backward_cuda_launches": 3 * fr.backward_launches(spec)}
    if per_step != want:
        raise AssertionError(f"launches per vocoder step {per_step} != {want}")
    return row


def phase_vocoder_card_vs_cpu(cfg, devices=("cpu", "cuda")):
    """One generator + discriminator step of the seeded full-width vocoder
    on two crops of the train split, at zero noise, on the CPU and on the
    card, with f32 and with bf16 cluster operands. The crops' f0 is moved to
    the nearest multiple of sr/1024 Hz, so the NSF phase sums are exact in
    float32 on both devices: at random init the gradient is discontinuous
    in the source (leaky-ReLU units at 0 switch slope), and two cumsum
    orders move it by about 1% (``tests/test_torch_vocoder_step.py``).
    f32: losses within 1e-4 relative; each optimizer group's gradient
    within 1e-3 of its norm (relative L2); the discriminators' also per
    tensor, max|d| within 1e-3 of the tensor's scale (max(max|g_cpu|, 1e-3
    of the group's largest)). The generator's per-tensor error is printed,
    with the CPU's own change when the input mel moves by one ulp (1e-7
    relative), and not gated: at full width a few generator units sit
    within rounding of 0 and switch slope under any other summation order,
    so a one-ulp change of the input or the weights moves single generator
    tensors by up to 0.45% of their scale (0.16% in their L2 norm) on the
    CPU alone, and the whole generator gradient by about 1e-4 in L2. bf16:
    per loss |card - cpu_bf16| <= max(1e-4 |cpu_bf16|, VOC_LOSS_RATIO x
    |cpu_bf16 - cpu_f32|), the gap the bf16 operands open on the CPU;
    gradients are printed."""
    import numpy as np
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask, VocoderDataset
    t0 = time.perf_counter()
    runs = {}
    for mm, side, dev in ((torch.float32, "cpu", devices[0]), (torch.float32, "card", devices[1]),
                          (torch.float32, "cpu_ulp", devices[0]),
                          (torch.bfloat16, "cpu", devices[0]),
                          (torch.bfloat16, "card", devices[1])):
        hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
        with hparams_scope(hp, device=dev, zero_noise=True, disc_start_steps=0,
                           ds_workers=0) as h:
            ds = VocoderDataset("train")
            batch = ds.collater([ds[0], ds[1]])
            step = h["audio_sample_rate"] / 1024
            batch["f0"] = (np.round(batch["f0"] / step) * step).astype(np.float32)
            if side == "cpu_ulp":
                noise = np.random.RandomState(2).randn(*batch["mels"].shape)
                batch["mels"] = (batch["mels"] * (1 + 1e-7 * noise)).astype(np.float32)
            task = HifiGanTask()
            task.build_model()
            task.build_train()
            task.model.mm_dtype = mm
            grads = {}
            task.grad_hook = lambda group, params: grads.__setitem__(
                group, [p.grad.detach().cpu().double().clone() for p in params])
            names = {"gen": [n for n, _ in task.model.named_parameters()],
                     "disc": [f"mpd.{n}" for n, _ in task.mpd.named_parameters()]
                     + [f"msd.{n}" for n, _ in task.msd.named_parameters()]}
            logs = {}
            for idx in (0, 1):
                logs.update({k: float(v) for k, v in
                             task.training_step(batch, 1, idx)[1].items()})
            runs[side, mm] = logs, grads
    f32, bf16 = torch.float32, torch.bfloat16
    rel32 = {k: abs(runs["card", f32][0][k] - v) / max(abs(v), 1e-12)
             for k, v in runs["cpu", f32][0].items()}
    ok = max(rel32.values()) <= 1e-4
    groups = {}
    for group in ("gen", "disc"):
        ref = runs["cpu", f32][1][group]
        big = max(float(t.abs().max()) for t in ref)
        scales = [max(float(t.abs().max()), 1e-3 * big) for t in ref]

        def worst(a, b):
            return max(float((x - y).abs().max()) / sc for x, y, sc in zip(a, b, scales))

        def top(a, b, n=3):
            return sorted(((float((x - y).abs().max()) / sc, name) for x, y, sc, name in
                           zip(a, b, scales, names[group])), reverse=True)[:n]

        def l2(a, b):
            return float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
                         / torch.sqrt(sum((y ** 2).sum() for y in b)))
        card = runs["card", f32][1][group]
        floor = worst(runs["cpu_ulp", f32][1][group], ref)
        g = groups[group] = dict(
            card_vs_cpu_f32=worst(card, ref), card_vs_cpu_f32_l2=l2(card, ref),
            worst_tensors_f32=top(card, ref), cpu_one_ulp=floor,
            cpu_one_ulp_l2=l2(runs["cpu_ulp", f32][1][group], ref),
            card_vs_cpu_bf16=worst(runs["card", bf16][1][group], runs["cpu", bf16][1][group]),
            cpu_bf16_vs_f32=worst(runs["cpu", bf16][1][group], ref))
        ok = ok and g["card_vs_cpu_f32_l2"] <= 1e-3
        if group == "disc":
            ok = ok and g["card_vs_cpu_f32"] <= 1e-3
    loss16 = {}
    for k, v in runs["cpu", bf16][0].items():
        gap = abs(v - runs["cpu", f32][0][k])
        d = abs(runs["card", bf16][0][k] - v)
        tol = max(1e-4 * abs(v), VOC_LOSS_RATIO * gap)
        loss16[k] = dict(card_vs_cpu=d, cpu_bf16_f32_gap=gap, tol=tol, ok=d <= tol)
        ok = ok and d <= tol
    row = dict(ok=ok, batch=list(batch["wavs"].shape), tol_loss_f32=1e-4, tol_grad_l2=1e-3,
               loss_ratio_bf16=VOC_LOSS_RATIO, loss_rel_err_f32=rel32, losses_bf16=loss16,
               grads_over_scale=groups, losses_cpu_f32=runs["cpu", f32][0],
               seconds=time.perf_counter() - t0)
    emit("vocoder_train_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"vocoder card vs CPU: {rel32} {loss16} {groups}")
    return row


# phase 12: the two technique-prior recipes, trained across the phases and served
VARIANT_RECIPES = {"tech_mle": ("vae_tech_mle_eng_torch.yaml", "SVBVAETechMleTask"),
                   "seg_tech_mle": ("vae_seg_tech_mle_eng_torch.yaml", "SVBVAESegTechMleTask")}
VAR_STEPS, VAR_PHASE2 = 4, 2
# their map step has no a2p_mle term: the JAX step reads the a2p way's
# "kl", which the technique-prior variants do not return
VAR_PHASE_KEYS = {"2": PHASE_KEYS["2"], "3": PHASE_KEYS["3"] - {"a2p_mle"}}
# phase 13: every other variant's task class; the local one at latent 16
VARIANT_TASKS = {"tech_mle": ("SVBVAETechMleTask", {}),
                 "seg_tech_mle": ("SVBVAESegTechMleTask", {}),
                 "global": ("SVBVAEBoostTask", {}),
                 "local": ("SVBVAETask", {"latent_size": 16})}


def wav_rms(path):
    import numpy as np
    with wave.open(path) as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.float64)
    return float(np.sqrt(np.mean(pcm ** 2))) if pcm.size else 0.0


def phase_variants_train(voc, device="cuda"):
    """Both technique-prior recipes at full width on phase 6's splits:
    train steps 0-2 (phase 2, validating and vocoding at 0), resume for
    step 3 (phase 3, validating and vocoding at 4), ``--infer`` the test
    split. Returns the launches of the training processes and of the
    ``--infer`` ones, summed over the recipes."""
    import math
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks import svb_vae_task
    stages = len(voc["upsample_rates"])
    on_card = device == "cuda"  # CPU tensors take the plain cluster
    keys = ("resblock_conv1d_bf16_launches", "lrelu_bf16_launches", "resblock_conv1d_launches")

    def want(calls):
        return {keys[0]: 18 * stages * calls * on_card, keys[1]: stages * calls * on_card,
                keys[2]: 0}
    train_total, infer_total = dict.fromkeys(keys, 0), dict.fromkeys(keys, 0)
    rows, failed = {}, []
    for variant, (recipe, cls_name) in VARIANT_RECIPES.items():
        cfg = train_config(os.path.join(WORK, "voc"), device=device, recipe=recipe,
                           name=f"train_{variant}.yaml", phase_2_steps=VAR_PHASE2,
                           max_updates=VAR_PHASE2 + 1)
        work = os.path.join(WORK, f"train_{variant}")
        out2, wall2 = run_train_cli(cfg, work)
        out3, wall3 = run_train_cli(cfg, work, hp=f",max_updates={VAR_STEPS}", in_process=True)
        runs = {"2": summary_of(out2, "train"), "3": summary_of(out3, "train")}
        steps = {int(m.group(1)): json.loads(m.group(2))
                 for out in (out2, out3)
                 for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
        bad = []
        for step, logs in steps.items():
            phase = "2" if step - 1 <= VAR_PHASE2 else "3"
            if not all(math.isfinite(v) for v in logs.values()):
                bad.append(f"step {step}: non-finite {logs}")
            missing = VAR_PHASE_KEYS[phase] - set(logs)
            if step > 1 and missing:  # the discriminator starts after step 0
                bad.append(f"step {step} (phase {phase}) lacks {sorted(missing)}")
            if phase == "3" and "a2p_mle" in logs:
                bad.append(f"step {step}: a2p_mle in the map step")
        if sorted(steps) != list(range(1, VAR_STEPS + 1)):
            bad.append(f"logged steps {sorted(steps)}")

        def load(step):
            return torch.load(os.path.join(work, f"model_ckpt_steps_{step}.ckpt"),
                              map_location="cpu", weights_only=True)["state_dict"]
        c2, c3 = load(VAR_PHASE2 + 1), load(VAR_STEPS)
        hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                         global_hparams=False)
        with hparams_scope(hp):
            init = getattr(svb_vae_task, cls_name)()
            init.build_model()
            init.build_train()
        maps = tuple(f"{k}." for k in init.model.mapping_keys)
        phase2 = changed(init.model.state_dict(), c2["model"])
        phase3 = changed(c2["model"], c3["model"])
        invariants = {
            "phase2_changes_generator": bool(phase2),
            "phase2_keeps_asr_and_map": not any(k.startswith(("vc_asr.",) + maps)
                                                for k in phase2),
            "phase2_changes_disc": bool(changed(init.mel_disc.state_dict(), c2["mel_disc"])),
            "phase3_changes_only_map": bool(phase3) and all(k.startswith(maps)
                                                            for k in phase3),
            "phase3_keeps_disc": not changed(c2["mel_disc"], c3["mel_disc"]),
            "asr_never_changes": not any(k.startswith("vc_asr.") for k in changed(
                init.model.state_dict(), c3["model"]))}
        if variant == "seg_tech_mle":
            invariants["phase2_trains_attention"] = any(
                k.startswith("seg_ref_attn.") for k in phase2)
        # sanity validation at 0: a2a, p2p, gt_a; at 4: a2a, p2p, a2p, gt_a
        calls = {"2": 3, "3": 4}
        for phase, summ in runs.items():
            got = {k: summ[k] for k in keys}
            if summ["vocoder_calls"] != calls[phase] or got != want(calls[phase]):
                bad.append(f"phase {phase} run: {summ['vocoder_calls']} vocoder calls, "
                           f"launches {got}")
            for k in keys:
                train_total[k] += got[k]
        audio = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(work, "lightning_logs", "version_*", "audio", "*.wav")))
        if len(audio) != sum(calls.values()):
            bad.append(f"validation wavs {audio}")
        infer, wall_infer = run_train_cli(cfg, work, "--infer", in_process=True)
        isum = summary_of(infer, "infer")
        gen_dir = os.path.join(work, f"generated_{VAR_STEPS}_", "wavs")
        wavs = {k: sorted(glob.glob(os.path.join(gen_dir, f"{k}_wavout", "*.wav")))
                for k in ("gt_a", "gt_p", "a2a", "p2p", "a2p")}
        n_wavs = sum(len(v) for v in wavs.values())
        silent = [os.path.basename(p) for v in wavs.values() for p in v if wav_rms(p) < 1.0]
        got = {k: isum[k] for k in keys}
        if n_wavs != 20 or silent or got != want(n_wavs):
            bad.append(f"--infer: {n_wavs} wavs, silent {silent}, launches {got}")
        for k in keys:
            infer_total[k] += got[k]
        rows[variant] = dict(
            recipe=recipe, ok=not bad and all(invariants.values()), problems=bad,
            invariants=invariants, wall_s={"phase2_run": wall2, "phase3_run_in_process": wall3,
                                          "infer": wall_infer},
            step_s={p: r["phases"][p] for p, r in runs.items()},
            max_memory_allocated={p: r.get("max_memory_allocated") for p, r in runs.items()},
            infer_rtf=isum["rtf"], infer_max_memory_allocated=isum.get("max_memory_allocated"),
            wavs=n_wavs, validation_wavs=len(audio),
            last_step_losses=steps.get(VAR_STEPS))
        print(f"| {variant} step seconds by phase: "
              f"{json.dumps(rows[variant]['step_s'])}; peak memory "
              f"{json.dumps(rows[variant]['max_memory_allocated'])}", flush=True)
        if not rows[variant]["ok"]:
            failed.append(variant)
    emit("variants_train", ok=not failed, train_launches=train_total,
         infer_launches=infer_total, **rows)
    if failed:
        raise AssertionError(f"variants train: {failed}: "
                             f"{ {v: rows[v]['problems'] for v in failed} }")
    return train_total, infer_total


def phase_variants_card_vs_cpu(devices=("cpu", "cuda")):
    """Every other variant's seeded full-width model (the local one at
    latent 16) forward on one test utterance of phase 6 at zero noise, on
    the CPU and on the card, TF32 off: each way's ``mel_out`` (and the
    sampled a2p decode) within 1e-3 as in phase 5, ``kl``/``mle`` within
    1e-4 relative, the seg attention weights within 1e-5. Then one gen+disc
    and one map step of the seg task in float64 at phase 9's gates."""
    import torch
    from neuralsvb_torch.data.datasets import MultiSpkEmbDataset
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks import svb_vae_task
    t0 = time.perf_counter()
    fwd, bad = {}, []
    for variant, (cls_name, over) in VARIANT_TASKS.items():
        cfg = train_config(os.path.join(WORK, "voc"), device=devices[0],
                           name=f"card_vs_cpu_{variant}.yaml", zero_noise=True,
                           ds_workers=0, **over)
        hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
        with hparams_scope(hp):
            task = getattr(svb_vae_task, cls_name)()
            model = task.build_model()
            ds = MultiSpkEmbDataset("test")
            batch = ds.collater([ds[0]])
            outs = {}
            for dev in devices:
                task.device = torch.device(dev)
                model.to(dev)
                with torch.no_grad():
                    out = task.forward(task._prep_batch(batch))
                outs[dev] = {(w, k): v.detach().cpu() for w, o in out.items()
                             for k, v in o.items() if k in ("mel_out", "a2p_sample_recon",
                                                           "kl", "mle", "attn")}
        cpu, card = outs[devices[0]], outs[devices[1]]
        row = {}
        for (way, key), ref in cpu.items():
            d = float((card[way, key] - ref).abs().max())
            if key in ("kl", "mle"):
                d /= max(float(ref.abs()), 1e-12)
            tol = {"kl": 1e-4, "mle": 1e-4, "attn": 1e-5}.get(key, 1e-3)
            row[f"{way}_{key}"] = d
            if not d <= tol or not bool(torch.isfinite(card[way, key]).all()):
                bad.append(f"{variant} {way} {key}: {d:.3e} > {tol}")
        fwd[variant] = dict(row, frames=int(batch["prof_mel_lengths"][0]))
    runs, train_batch = train_step_runs(
        svb_vae_task.SVBVAESegTechMleTask, (torch.float64,), devices,
        recipe=VARIANT_RECIPES["seg_tech_mle"][0], name="card_vs_cpu_steps.yaml")
    f64 = torch.float64
    rel = loss_rel(runs["card", f64][0], runs["cpu", f64][0])
    if runs["card", f64][0].keys() != runs["cpu", f64][0].keys() or max(rel.values()) > 1e-4:
        bad.append(f"seg step losses: {rel}")
    if any(k.endswith("a2p_mle") for k in runs["cpu", f64][0]):
        bad.append("a2p_mle in the seg map step")
    groups = {}
    for group in ("gen", "disc", "map"):
        scales = grad_scales(runs["cpu", f64][1][group])
        groups[group] = grads_over_scale(runs["card", f64][1][group],
                                         runs["cpu", f64][1][group], scales)
        if groups[group] > 1e-3:
            bad.append(f"seg {group} gradients: {groups[group]:.3e} of scale")
    emit("variants_card_vs_cpu", ok=not bad, problems=bad, forward=fwd,
         tol={"mel_out": 1e-3, "kl_mle_rel": 1e-4, "attn": 1e-5, "loss_rel": 1e-4,
              "grad_f64": 1e-3},
         seg_steps=dict(frames=640, batch=len(train_batch["id"]),
                        max_loss_rel_err_f64=max(rel.values()),
                        grads_over_scale_f64=groups, losses_cpu_f64=runs["cpu", f64][0]),
         seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"variants card vs CPU: {bad}")


# phase 14: the Parallel WaveGAN recipe trained on phase 10's split and served
PWG_STEPS, PWG_RESUME, PWG_DISC_START, PWG_VAL_EVERY = 8, 10, 2, 3
PWG_GEN_KEYS = {"sc", "mag", "a", "lr_0"}
PWG_DISC_KEYS = {"r", "f", "lr_1"}
PWG_BATCH, PWG_TIMED_STEPS = 5, 5  # the recipe's max_sentences; warm steps timed
PWG_CARD_VS_CPU_SAMPLES = 12800  # two crops of 100 frames for the float64 steps
PWG_RECIPE = "egs/egs_bases/tts/vocoder/pwg_torch.yaml"


def pwg_config(device="cuda", **over):
    """``pwg_torch.yaml`` at full width (30 layers in 3 stacks, 64/128/64
    channels, the recipe's batch of 5 x 25600 samples) on phase 10's packed
    split. That split is hop 128, so the upsample scales are 4,4,4,2 and the
    context window 0, each set in both the task's keys and the vocoder
    loader's (``generator_params.upsample_params``,
    ``generator_params.aux_context_window``)."""
    import yaml
    cfg = os.path.join(WORK, "pwg_train.yaml")
    scales = [4, 4, 4, 2]
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(REPO, PWG_RECIPE)],
            "binary_data_dir": os.path.join(WORK, "vocoder_binary"), "device": device,
            "hop_size": 128, "aux_context_window": 0,
            "generator_params": {"upsample_scales": scales, "aux_context_window": 0,
                                 "upsample_params": {"upsample_scales": scales}},
            "max_updates": PWG_STEPS, "disc_start_steps": PWG_DISC_START,
            "val_check_interval": PWG_VAL_EVERY, "num_sanity_val_steps": 1,
            "tb_log_interval": 1, "ds_workers": 1}, **over), f)
    return cfg


def phase_pwg_train(device="cuda"):
    """Train the PWG recipe 8 steps (the discriminator from step 3), resume
    to 10, then render the SVB test split through it; returns the config."""
    import math
    import numpy as np
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vocoder_task import PWGTask
    cfg = pwg_config(device)
    work = os.path.join(WORK, "pwg_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    bad = []
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
    for n, logs in steps.items():  # "step n" logs step n - 1
        want = PWG_GEN_KEYS | (PWG_DISC_KEYS if n - 1 > PWG_DISC_START else set())
        if set(logs) - {"total_loss_0", "total_loss_1"} != want:
            bad.append(f"step {n} logs {sorted(logs)}")
        if not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {n}: non-finite {logs}")
    if sorted(steps) != list(range(1, PWG_STEPS + 1)):
        bad.append(f"logged steps {sorted(steps)}")
    validations = out.count("| Valid results:")
    valid_keys = re.findall(r"^\| Valid results: (\{.*\})$", out, re.M)
    if not valid_keys or any("'sc'" not in v or "'mag'" not in v for v in valid_keys):
        bad.append(f"validation results {valid_keys}")
    hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    with hparams_scope(hp):
        init = PWGTask()
        init.build_model()

    def load(step):
        return torch.load(os.path.join(work, f"model_ckpt_steps_{step}.ckpt"),
                          map_location="cpu", weights_only=True)
    # the step-3 checkpoint holds steps 0-2, which leave the discriminator
    # alone (step <= disc_start_steps); the step-6 one holds three of its steps
    c3, c6 = load(PWG_VAL_EVERY), load(2 * PWG_VAL_EVERY)
    invariants = {
        "generator_changes_by_3": bool(changed(init.model.state_dict(),
                                               c3["state_dict"]["model_gen"])),
        "disc_unchanged_by_3": not changed(init.disc.state_dict(), c3["state_dict"]["disc"]),
        "disc_changes_by_6": bool(changed(c3["state_dict"]["disc"], c6["state_dict"]["disc"]))}
    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={PWG_RESUME}",
                                         in_process=True)
    rs = summary_of(resumed, "train")
    if (rs["start_step"], rs["end_step"]) != (PWG_STEPS, PWG_RESUME) \
            or f"model_ckpt_steps_{PWG_STEPS}.ckpt" not in resumed:
        bad.append(f"resume: {rs['start_step']} -> {rs['end_step']}")
    c10 = load(PWG_RESUME)
    # RAdam's rectified update starts at its sixth step
    counts = [sorted({st["step"] for st in o["state"].values()})
              for o in c10["optimizer_states"]]
    want_counts = [[PWG_RESUME], [PWG_RESUME - PWG_DISC_START - 1]]
    if counts != want_counts or min(c[0] for c in counts) < 6:
        bad.append(f"optimizer step counts {counts} != {want_counts}")
    launches = {k: v for k, v in s.items() if k.endswith("_launches")}
    if any(launches.values()):  # PWG runs none of the repo's kernels
        bad.append(f"kernel launches {launches}")

    # the SVB test split rendered through the trained PWG
    svb_cfg = train_config(os.path.join(WORK, "voc"), device=device)
    infer, wall_infer = run_train_cli(
        svb_cfg, os.path.join(WORK, "train_work"), "--infer",
        hp=f",vocoder=PWG,vocoder_ckpt={work},gen_dir_name=pwg", in_process=True)
    if f"| Loaded PWG weights from {work}/model_ckpt_steps_{PWG_RESUME}.ckpt" not in infer:
        bad.append("--infer did not load the trained PWG")
    gen = os.path.join(WORK, "train_work", f"generated_{TRAIN_RESUME}_pwg")
    rendered, rms = 0, []
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        wavs = sorted(glob.glob(os.path.join(gen, "wavs", f"{key}_wavout", "*.wav")))
        mels = sorted(glob.glob(os.path.join(gen, "mels", f"{key}_mel", "*.npy")))
        for wf, mf in zip(wavs, mels):
            with wave.open(wf) as f:
                n = f.getnframes()
            if n != 128 * np.load(mf).shape[0]:
                bad.append(f"{wf}: {n} samples for {np.load(mf).shape[0]} frames")
            rms.append(wav_rms(wf))
            rendered += 1
    if rendered != 5 * 4 or min(rms or [0]) < 1.0:
        bad.append(f"{rendered} wavs rendered, rms {rms}")
    row = dict(ok=not bad and all(invariants.values()), problems=bad, invariants=invariants,
               wall_s=wall, resume_in_process_wall_s=wall_resume,
               infer_in_process_wall_s=wall_infer, summary=s,
               resume_summary=rs, validations=validations, optimizer_step_counts=counts,
               rendered_wavs=rendered, min_rms_int16=min(rms or [0]),
               infer_rtf=summary_of(infer, "infer")["rtf"],
               last_step_losses=steps.get(PWG_STEPS))
    emit("pwg_train", **row)
    print(f"| train summary: {json.dumps(s)}", flush=True)
    if not row["ok"]:
        raise AssertionError(f"PWG train phase failed: {bad} {invariants}")
    return cfg


def phase_pwg_step_time():
    """Warm generator + discriminator steps of the PWG recipe at its own
    shapes (B = 5 x 25600 samples, scales 4,4,4,4, hop 256) on synthetic
    crops, in this process: first step, median/min/max of the warm ones,
    peak memory and one step under ``torch.profiler`` (kernel time by kind,
    busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsvb_torch.data.synthetic import synthetic_crops
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vocoder_task import PWGTask
    hp = set_hparams(config=os.path.join(REPO, PWG_RECIPE), print_hparams=False,
                     global_hparams=False)
    with hparams_scope(hp, disc_start_steps=0, binary_data_dir="") as h:
        task = PWGTask()
        task.build_model()
        task.build_train()
        batch = synthetic_crops(PWG_BATCH, h)
        shape = dict(batch=[PWG_BATCH, h["max_samples"]], hop=h["hop_size"],
                     upsample_scales=list(task.model.upsample_scales))

        def step(i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            task.training_step(batch, i, 0)
            task.training_step(batch, i, 1)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        first = step(1)
        warm = [step(2 + i) for i in range(PWG_TIMED_STEPS)]
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = step(2 + PWG_TIMED_STEPS)
    med = statistics.median(warm)
    row = dict(shape, first_step_s=first,
               warm_steps_s=warm, median_s=med, min_s=min(warm), max_s=max(warm),
               max_memory_allocated=peak, profiled_step=profiled_step(prof, wall, med))
    emit("pwg_step_time", **row)
    return row


def phase_pwg_card_vs_cpu(cfg, devices=("cpu", "cuda")):
    """One generator + discriminator step of the seeded full-width PWG on
    two crops of 100 frames of the train split, in float64 on the CPU and
    on the card (the same z, drawn on the CPU), TF32 off: losses within
    1e-4 relative, each gradient within 1e-3 of its tensor's scale
    (max(max|g_cpu|, 1e-3 of the group's largest)), phase 9's gates."""
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vocoder_task import PWGTask, VocoderDataset
    t0 = time.perf_counter()
    f64 = torch.float64
    runs = {}
    for side, dev in zip(("cpu", "card"), devices):
        hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
        with hparams_scope(hp, device=dev, disc_start_steps=0, ds_workers=0,
                           max_samples=PWG_CARD_VS_CPU_SAMPLES):
            ds = VocoderDataset("train")
            batch = ds.collater([ds[0], ds[1]])
            task = PWGTask()
            task.build_model()
            task.model.to(f64)
            task.disc.to(f64)
            task.build_train()
            prep = task._prep_batch  # float32, the training path's; the check runs in float64
            task._prep_batch = lambda batch, prep=prep: {k: v.to(f64)
                                                         for k, v in prep(batch).items()}
            z = torch.randn((2, 1, PWG_CARD_VS_CPU_SAMPLES), dtype=f64,
                            generator=torch.Generator().manual_seed(5))
            task.noise = lambda wavs, generator: z.to(wavs.device)
            grads = {}
            task.grad_hook = lambda group, params: grads.__setitem__(
                group, [p.grad.detach().cpu().clone() for p in params])
            logs = {}
            for idx in (0, 1):
                logs.update({k: float(torch.as_tensor(v).detach()) for k, v in
                             task.training_step(batch, 1, idx)[1].items()})
            runs[side] = logs, grads
    rel = loss_rel(runs["card"][0], runs["cpu"][0])
    ok = runs["card"][0].keys() == runs["cpu"][0].keys() and max(rel.values()) <= 1e-4
    groups = {}
    for group in ("gen", "disc"):
        ref = runs["cpu"][1][group]
        groups[group] = grads_over_scale(runs["card"][1][group], ref, grad_scales(ref))
        ok = ok and groups[group] <= 1e-3
    row = dict(ok=ok, batch=[2, PWG_CARD_VS_CPU_SAMPLES], tol_loss=1e-4, tol_grad_f64=1e-3,
               loss_rel_err_f64=rel, grads_over_scale_f64=groups, losses_cpu_f64=runs["cpu"][0],
               seconds=time.perf_counter() - t0)
    emit("pwg_train_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"PWG card vs CPU: {rel} {groups}")
    return row


# phase 15: a JAX-format HiFiGAN checkpoint read on the card machine
def _mp_header(n, fix, fix_max, wide):
    """A msgpack length header: ``fix | n`` up to ``fix_max``, else the
    smallest of ``wide`` ((code, struct format, max), ...)."""
    import struct
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in wide:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _mp_str(s):
    b = s.encode("utf-8")
    return _mp_header(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                          (0xDB, ">I", 0xFFFFFFFF))) + b


def _mp_uint(n):
    import struct
    if n <= 0x7F:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)


def _mp_ndarray(a):
    """flax's ndarray: ext type 1 around msgpack ``(shape, dtype name, C bytes)``."""
    import numpy as np
    a = np.ascontiguousarray(a)
    raw = a.tobytes("C")
    payload = (b"\x93"  # (shape, dtype name, bytes)
               + _mp_header(a.ndim, 0x90, 15, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
               + b"".join(_mp_uint(int(d)) for d in a.shape) + _mp_str(a.dtype.name)
               + _mp_header(len(raw), None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                                (0xC6, ">I", 0xFFFFFFFF))) + raw)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixext[n]]) if n in fixext else
            _mp_header(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF))))
    return head + bytes([1]) + payload


def flax_msgpack_bytes(tree):
    """A minimal encoder of ``flax.serialization.to_bytes``'s format for a
    tree of str-keyed dicts with numpy array leaves (under 2^30 bytes each)."""
    if isinstance(tree, dict):
        head = _mp_header(len(tree), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                                (0xDF, ">I", 0xFFFFFFFF)))
        return head + b"".join(_mp_str(k) + flax_msgpack_bytes(v) for k, v in tree.items())
    return _mp_ndarray(tree)


def hifigan_jax_tree(sd):
    """The port's ResBlock1 HiFiGAN-NSF state_dict in the JAX generator's
    param tree: the inverse of ``hifigan_from_jax`` (conv kernels
    [out, in, k] -> [k, in, out], dense [out, in] -> [in, out])."""
    def conv(prefix):
        t = {"kernel": sd[f"{prefix}.weight"].numpy().transpose(2, 1, 0)}
        if f"{prefix}.bias" in sd:
            t["bias"] = sd[f"{prefix}.bias"].numpy()
        return t
    tree = {"conv_pre": conv("conv_pre"), "conv_post": conv("conv_post")}
    if "m_source.l_linear.weight" in sd:
        tree["m_source"] = {"l_linear": {"kernel": sd["m_source.l_linear.weight"].numpy().T,
                                         "bias": sd["m_source.l_linear.bias"].numpy()}}
    n_up = sum(1 for k in sd if re.fullmatch(r"ups\.\d+\.weight", k))
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("resblocks.")})
    n_k = n_blocks // n_up
    for i in range(n_up):
        tree[f"up_{i}"] = conv(f"ups.{i}")
        if f"noise_convs.{i}.weight" in sd:
            tree[f"noise_conv_{i}"] = conv(f"noise_convs.{i}")
        for j in range(n_k):
            r = i * n_k + j
            n_c = sum(1 for k in sd if re.fullmatch(rf"resblocks\.{r}\.convs1\.\d+\.weight", k))
            tree[f"resblock_{i}_{j}"] = {
                f"conv{s}_{c}": conv(f"resblocks.{r}.convs{s}.{c}")
                for c in range(n_c) for s in (1, 2)}
    return tree


def _same_tree(a, b):
    import numpy as np
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def phase_jax_checkpoint(voc, device="cuda"):
    """Seeded full-width HiFiGAN-NSF weights written as a JAX
    ``params.msgpack`` (``flax_msgpack_bytes`` of ``hifigan_jax_tree``) and
    as a port checkpoint; the vocoder loads each and vocodes one mel of 2000
    frames (the 2048 bucket) at zero noise through the bf16 ResBlock kernel:
    the two wavs must be bit-identical and the JAX-format vocoder's call
    must launch 18 x stages convs and one pre-pass per stage. The file
    decodes to the written tree exactly. Returns the JAX-format call's
    launches."""
    import numpy as np
    import torch
    import yaml
    from neuralsvb_torch.convert import msgpack_ckpt
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.vocoders.hifigan import HifiGAN, load_hifigan
    root = os.path.join(WORK, "jax_ckpt")
    dirs = {k: os.path.join(root, k) for k in ("jax", "port")}
    seeded, _, _ = load_hifigan("", dict(voc, seed=7), torch.device("cpu"))
    sd = {k: v.contiguous() for k, v in seeded.state_dict().items()}
    tree = hifigan_jax_tree(sd)
    for d in dirs.values():
        os.makedirs(d)
        with open(os.path.join(d, "config.yaml"), "w") as f:
            yaml.safe_dump(voc, f)
    with open(os.path.join(dirs["jax"], "params.msgpack"), "wb") as f:
        f.write(flax_msgpack_bytes(tree))
    torch.save({"state_dict": {"model_gen": sd}},
               os.path.join(dirs["port"], "model_ckpt_steps_1.ckpt"))
    decoded = msgpack_ckpt.load(os.path.join(dirs["jax"], "params.msgpack"))
    T = 2000
    t = np.arange(T) * 128 / SR
    f0 = (220.0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))).astype(np.float32)
    mel = (np.random.RandomState(3).randn(T, voc["audio_num_mel_bins"]) - 4).astype(np.float32)
    wavs, launches = {}, {}
    for kind, d in dirs.items():
        vocoder = HifiGAN(dict(voc, vocoder_ckpt=d, device=device, seed=1234,
                               vocoder_denoise_c=0.0))
        for c in fr.KERNEL_COUNTERS:
            c.launches = 0
        wavs[kind] = vocoder.spec2wav(mel, f0=f0, zero_noise=True).cpu()
        launches[kind] = {c.__name__: c.launches for c in fr.KERNEL_COUNTERS}
    stages = len(voc["upsample_rates"])
    on_card = device == "cuda"  # CPU tensors take the plain cluster
    want = {"resblock_conv1d_bf16": 18 * stages * on_card, "lrelu_bf16": stages * on_card,
            "resblock_conv1d": 0, "resblock_cluster_backward_cuda": 0}
    row = dict(decoded_tree_exact=_same_tree(tree, decoded),
               wav_samples=int(wavs["jax"].numel()), bit_identical=torch.equal(
                   wavs["jax"], wavs["port"]), finite=bool(torch.isfinite(wavs["jax"]).all()),
               launches=launches["jax"], expected_launches=want)
    hop = int(np.prod(voc["upsample_rates"]))
    row["ok"] = (row["decoded_tree_exact"] and row["bit_identical"] and row["finite"]
                 and row["wav_samples"] == T * hop and launches["jax"] == want)
    emit("jax_checkpoint", **row)
    if not row["ok"]:
        raise AssertionError(f"JAX checkpoint phase failed: {row}")
    return launches["jax"]


VC_RECIPE = "egs/egs_bases/vc/vc_ppg_torch.yaml"
VC_SPEAKERS, VC_UTTS, VC_TEST_NUM = 2, 24, 4
VC_STEPS, VC_RESUME, VC_VAL_EVERY = 4, 6, 2
VC_GEN_KEYS, VC_DISC_KEYS = {"l1", "ssim", "asr", "a", "lr_0"}, {"r", "f", "lr_1"}
VC_CARD_VS_CPU = dict(items=3, frames=320, starts=[40, 80, 120])
def vcppg_config(device="cuda", name="vcppg.yaml", **over):
    """The ASR pre-training recipe at its full width (hidden 256, conformer
    ASR 2 + 2 layers, 4 decoder conv layers, discriminator 3 windows x 128
    channels) on phase 16's corpus."""
    import yaml
    root = os.path.join(WORK, "vcppg")
    cfg = os.path.join(WORK, name)
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(REPO, VC_RECIPE)],
            "processed_data_dir": os.path.join(root, "processed"),
            "binary_data_dir": os.path.join(root, "binary"), "device": device,
            "test_num": VC_TEST_NUM, "ds_workers": 1, "max_updates": VC_STEPS,
            "val_check_interval": VC_VAL_EVERY, "num_sanity_val_steps": 1,
            "tb_log_interval": 1}, **over), f)
    return cfg


def phase_vcppg_binarize(device="cuda"):
    """The speech corpus through ``python -m neuralsvb_torch.data.binarize``
    with the ASR pre-training recipe; returns its config."""
    import numpy as np
    from neuralsvb_torch.data.synthetic import write_synthetic_speech_corpus
    write_synthetic_speech_corpus(os.path.join(WORK, "vcppg", "processed"), VC_SPEAKERS,
                                  VC_UTTS)
    cfg = vcppg_config(device)
    wall, summary = run_binarize(cfg, device)
    binary = os.path.join(WORK, "vcppg", "binary")
    with open(os.path.join(binary, "phone_set.json")) as f:
        phones = json.load(f)
    bad = []
    n_items = {}
    for prefix in ("train", "valid", "test"):
        items = read_split(binary, prefix)
        n_items[prefix] = len(items)
        for it in items:
            ids = np.asarray(it["phone"])
            if it["ph"].split(" ") != [phones[i - 4] for i in ids] or it["ph_len"] != len(ids):
                bad.append(f"{it['item_name']}: phones {it['ph'][:40]} vs {ids[:8]}")
            if not (np.isfinite(it["mel"]).all() and (it["f0"] > 0).mean() > 0.5
                    and len(it["f0"]) == len(it["mel"]) and it["txt"]):
                bad.append(f"{it['item_name']}: mel/f0/txt")
    want = {"train": VC_SPEAKERS * VC_UTTS - VC_TEST_NUM, "valid": VC_TEST_NUM,
            "test": VC_TEST_NUM}
    if n_items != want or summary["items"] != want:
        bad.append(f"items {n_items} {summary['items']} != {want}")
    row = dict(ok=not bad, problems=bad, wall_s=wall, items=n_items,
               phone_set_size=len(phones), summary=summary)
    emit("vcppg_binarize", **row)
    if bad:
        raise AssertionError(f"vcppg binarize: {bad}")
    return cfg


def phase_vcppg_train(cfg):
    """``VCPPGTask`` at full width: 4 steps (the discriminator from step 1,
    validating at 0, 2 and 4), then a resume to 6; returns the work dir."""
    import math
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vc_ppg import VCPPGTask
    work = os.path.join(WORK, "vcppg_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={VC_RESUME}",
                                         in_process=True)
    rs = summary_of(resumed, "train")
    bad = []
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out + resumed, re.M)}
    for n, logs in steps.items():  # "step n" logs step n - 1
        want = VC_GEN_KEYS | VC_DISC_KEYS if n > 1 else VC_GEN_KEYS - {"a"}
        if set(logs) - {"total_loss_0", "total_loss_1"} != want:
            bad.append(f"step {n} logs {sorted(logs)}")
        if not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {n}: non-finite {logs}")
    if sorted(steps) != list(range(1, VC_RESUME + 1)):
        bad.append(f"logged steps {sorted(steps)}")
    valid = re.findall(r"^\| Valid results: (\{.*\})$", out, re.M)
    if len(valid) != VC_STEPS // VC_VAL_EVERY + 1 or any("'asr'" not in v for v in valid):
        bad.append(f"validations {valid}")
    if (rs["start_step"], rs["end_step"]) != (VC_STEPS, VC_RESUME):
        bad.append(f"resume {rs['start_step']} -> {rs['end_step']}")
    if any(v for k, v in {**s, **rs}.items() if k.endswith("_launches")):
        bad.append("a kernel of the repo launched")  # this path computes none
    hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    with hparams_scope(hp):
        init = VCPPGTask()
        init.build_model()
        init.build_train()

    def load(step):
        return torch.load(os.path.join(work, f"model_ckpt_steps_{step}.ckpt"),
                          map_location="cpu", weights_only=True)["state_dict"]
    c4, c6 = load(VC_STEPS), load(VC_RESUME)
    moved = changed(init.model.state_dict(), c4["model"])
    invariants = {
        "asr_decoder_trains": any(k.startswith("vc_asr.asr_decoder.") for k in moved),
        "asr_encoder_trains": any(k.startswith("vc_asr.content_encoder.") for k in moved),
        "asr_statistics_stay": not any(k.startswith("vc_asr.") and "running" in k
                                       for k in changed(init.model.state_dict(), c6["model"])),
        "mel_decoder_trains": any(k.startswith("decoder.") for k in moved),
        "disc_trains": bool(changed(init.mel_disc.state_dict(), c4["mel_disc"]))}
    row = dict(ok=not bad and all(invariants.values()), problems=bad, invariants=invariants,
               wall_s=wall, resume_in_process_wall_s=wall_resume, summary=s,
               resume_summary=rs,
               validations=valid, last_step_losses=steps.get(VC_RESUME))
    emit("vcppg_train", **row)
    print(f"| train summary: {json.dumps(s)}", flush=True)
    if not row["ok"]:
        raise AssertionError(f"vcppg train: {bad} {invariants}")
    return work


def phase_vcppg_step_time():
    """``scripts/train_profile.py`` on the ASR pre-training recipe: warm
    generator + discriminator steps at its token budget (40 x 750 frames)."""
    out = os.path.join(WORK, "vcppg_profile.json")
    proc = subprocess.run([sys.executable, "scripts/train_profile.py", "--config", VC_RECIPE,
                           "--out", out, "--warm", "5"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"train_profile failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out) as f:
        res = json.load(f)[0]
    warm, prof = res["phase2_warm_steps_s"], res["profiled_phase2_step"]
    row = dict(batch=res["batch"], first_step_s=res["phase2_first_step_s"], warm_steps_s=warm,
               median_s=res["phase2_median_s"], min_s=min(warm), max_s=max(warm),
               max_memory_allocated=res["max_memory_allocated"],
               profiled_step={k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                   "busy_share_of_unprofiled_median",
                                                   "merged_busy_ms", "merged_busy_share",
                                                   "merged_busy_share_of_unprofiled_median",
                                                   "launches", "by_kind_ms")},
               top_kernels=prof["top_kernels"][:10], nvidia_smi=res["nvidia_smi"])
    emit("vcppg_step_time", **row)
    return row


def phase_vcppg_card_vs_cpu(cfg, devices=("cpu", "cuda")):
    """One generator and one discriminator step of the seeded full-width
    ``VCPPGTask`` on the card and on the CPU, from the same float32 weights,
    in float32 (the training path) and float64, on three train items cropped
    to 320 frames, with pinned discriminator windows and the same dropout
    masks (drawn on the CPU), TF32 off. Gates: losses within 1e-4 relative in
    both dtypes; gradients, per tensor, card against CPU in float64 within
    1e-3 of the tensor's scale (max(max|g|, 1e-3 of the group's largest));
    the float32 differences are printed beside them."""
    import torch
    from neuralsvb_torch.data.datasets import FastSpeechDataset
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.vc_ppg import VCPPGTask
    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    runs = {}
    for dtype in (f32, f64):
        for side, dev in zip(("cpu", "card"), devices):
            hp = set_hparams(config=cfg, hparams_str=f"device={dev},max_frames="
                             f"{VC_CARD_VS_CPU['frames']}", print_hparams=False,
                             global_hparams=False)
            with hparams_scope(hp):
                task = VCPPGTask()
                task.build_model()
                task.build_train()
                task.model.to(dtype)
                task.mel_disc.to(dtype)
                task.rand_device = torch.device("cpu")
                task.disc_start_frames_wins = VC_CARD_VS_CPU["starts"]
                grads = {}
                task.grad_hook = lambda group, params: grads.__setitem__(
                    group, [p.grad.detach().cpu().double().clone() for p in params])
                names = {"gen": [n for n, _ in task.model.named_parameters()],
                         "disc": [n for n, _ in task.mel_disc.named_parameters()]}
                ds = FastSpeechDataset("train")
                batch = ds.collater([ds[i] for i in range(VC_CARD_VS_CPU["items"])])
                torch.set_default_dtype(dtype)
                try:
                    logs = {}
                    for idx in (0, 1):
                        logs.update({f"{idx}/{k}": float(torch.as_tensor(v).detach())
                                     for k, v in task.training_step(batch, 1, idx)[1].items()})
                finally:
                    torch.set_default_dtype(f32)
                runs[side, dtype] = logs, grads
    rel32 = loss_rel(runs["card", f32][0], runs["cpu", f32][0])
    rel64 = loss_rel(runs["card", f64][0], runs["cpu", f64][0])
    ok = max(rel32.values()) <= 1e-4 and max(rel64.values()) <= 1e-4
    groups = {}
    for group in ("gen", "disc"):
        scales = grad_scales(runs["cpu", f64][1][group])
        g = {(side, dt): runs[side, dt][1][group] for side in ("cpu", "card") for dt in (f32, f64)}
        off = [float((x - y).abs().max()) / sc
               for x, y, sc in zip(g["card", f32], g["cpu", f64], scales)]
        groups[group] = dict(
            card_vs_cpu_f64=grads_over_scale(g["card", f64], g["cpu", f64], scales),
            card_vs_cpu_f32=grads_over_scale(g["card", f32], g["cpu", f32], scales),
            card_f32_vs_f64=grads_over_scale(g["card", f32], g["cpu", f64], scales),
            cpu_f32_vs_f64=grads_over_scale(g["cpu", f32], g["cpu", f64], scales),
            card_f32_worst_tensor=names[group][off.index(max(off))])
        ok = ok and groups[group]["card_vs_cpu_f64"] <= 1e-3
    row = dict(ok=ok, items=VC_CARD_VS_CPU["items"], frames=VC_CARD_VS_CPU["frames"],
               max_loss_rel_err_f32=max(rel32.values()), max_loss_rel_err_f64=max(rel64.values()),
               tol_loss=1e-4, tol_grad_f64=1e-3, grads_over_scale=groups,
               losses_cpu_f32=runs["cpu", f32][0], seconds=time.perf_counter() - t0)
    emit("vcppg_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"vcppg card vs CPU: {rel32} {rel64} {groups}")
    return row


def phase_vcppg_warm_start(voc, vc_work, device="cuda"):
    """The flagship recipe with ``pretrain_asr_ckpt`` at phase 17's work dir:
    one training step on phase 6's splits, whose step-0 validation vocodes
    its first batch through HiFiGAN-NSF. Its frozen ASR must equal the
    ASR pre-training checkpoint's bit for bit (parameters and statistics),
    and the bf16 ResBlock kernel launches 54 convs + 3 pre-passes per
    vocoder call. Returns the run's launches."""
    import torch
    from neuralsvb_torch.convert.checkpoint import newest_checkpoint
    cfg = train_config(os.path.join(WORK, "voc"), device=device, name="warm_start.yaml",
                       pretrain_asr_ckpt=vc_work, max_updates=1)
    work = os.path.join(WORK, "warm_start_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    source = newest_checkpoint(vc_work)
    vc = torch.load(source, map_location="cpu", weights_only=True)["state_dict"]["model"]
    flagship = torch.load(os.path.join(work, "model_ckpt_steps_1.ckpt"), map_location="cpu",
                          weights_only=True)["state_dict"]["model"]
    asr = {k: v for k, v in flagship.items() if k.startswith("vc_asr.")}
    differ = sorted(k for k, v in asr.items() if not torch.equal(v, vc[k]))
    calls = s["vocoder_calls"]
    stages = len(voc["upsample_rates"])
    on_card = device == "cuda"
    want = {"resblock_conv1d_bf16_launches": 18 * stages * calls * on_card,
            "lrelu_bf16_launches": stages * calls * on_card, "resblock_conv1d_launches": 0}
    launches = {k: s[k] for k in want}
    loaded = re.findall(r"^\| Loaded the ASR from (.*)$", out, re.M)
    ok = (not differ and bool(asr) and loaded == [source] and calls == 3 and launches == want)
    emit("vcppg_warm_start", ok=ok, wall_s=wall, source=os.path.relpath(source, REPO),
         asr_tensors=len(asr), asr_tensors_differing=differ,
         skipped_decoder_tensors=len([k for k in vc if k.startswith("vc_asr.asr_decoder.")
                                      or k.startswith("vc_asr.token_embed.")]),
         vocoder_calls=calls, launches=launches, expected_launches=want, summary=s)
    if not ok:
        raise AssertionError(f"warm start: {differ} {loaded} {calls} {launches} {want}")
    return launches


# ---------------------------------------------------------------------------
# the flagship's training options (phases 21-25)
# ---------------------------------------------------------------------------

# phase 22: the bf16 step (float32 master weights) on the card against the
# CPU step in float64. bf16 keeps 8 bits of mantissa (relative rounding
# 2^-9), and the flagship's gradient in bf16 is far from float64's: the JAX
# package's own bf16 generator gradient is 0.44 (L2, relative) from its
# float32 one at tiny widths on the CPU, most of it in the posterior
# encoder, and the latent map's float32 gradient is already ill-conditioned
# (PERF.md §5). The gates catch a wrong cast or a lost gradient
# (errors of order 1 in the generator's and discriminator's direction),
# not bf16's own rounding (PERF.md §6).
BF16_LOSS_REL, BF16_LOSS_ABS = 0.1, 1e-4  # per logged loss: |d| <= rel |ref| + abs
BF16_GRAD_COS = 0.8       # gen and disc: cosine of the gradient to float64's
BF16_UPDATE_COS = 0.5     # gen and disc: cosine of the parameter change to float64's
# every training-mode BatchNorm call: max |out - float64| / max |float64|
# on its own input (``NormStatsCheck``; sound runs and a planted bf16
# statistics fault measured by ``scripts/bf16_map_spread.py``, PERF.md §6)
BF16_NORM_ERR = 0.03
# phase 24: the bf16 vocoder against the float32 one (CPU at full width:
# 0.0058 and 0.015 of the float32 wav's mean and max magnitude)
BF16_WAV_MEAN_REL, BF16_WAV_MAX_REL = 0.03, 0.05


def phase_bf16_step_time():
    """``scripts/train_profile.py`` on the flagship at the train cell's B = 4
    x 2560 frames, float32 then ``compute_dtype: bfloat16`` in one process:
    warm phase-2 and phase-3 medians, peak memory and the profiled phase-2
    step's split and busy share, side by side."""
    out = os.path.join(WORK, "bf16_profile.json")
    proc = subprocess.run([sys.executable, "scripts/train_profile.py", "--out", out,
                           "--warm", "4", "--variant", "f32:",
                           "--variant", "bf16:compute_dtype=bfloat16"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"train_profile failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out) as f:
        res = {r["variant"]: r for r in json.load(f)}
    row = {}
    for name, r in res.items():
        prof = r["profiled_phase2_step"]
        row[name] = dict(
            phase2_median_s=r["phase2_median_s"], phase2_warm_steps_s=r["phase2_warm_steps_s"],
            phase2_first_step_s=r["phase2_first_step_s"], phase3_median_s=r["phase3_median_s"],
            max_memory_allocated=r["max_memory_allocated"],
            profiled_step={k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                "busy_share_of_unprofiled_median",
                                                "merged_busy_ms", "merged_busy_share",
                                                "merged_busy_share_of_unprofiled_median",
                                                "launches", "by_kind_ms")})
    ok = all(math.isfinite(v["phase2_median_s"]) for v in row.values()) and set(row) == {
        "f32", "bf16"}
    emit("bf16_step_time", ok=ok, batch=res["f32"]["batch"], nvidia_smi=res["f32"]["nvidia_smi"],
         bf16_over_f32=row["bf16"]["phase2_median_s"] / row["f32"]["phase2_median_s"], **row)
    if not ok:
        raise AssertionError(f"bf16 step time: {row}")
    return row


def phase_bf16_card_vs_cpu(runs, cpu64_deltas, cpu64_state, devices=("cuda",)):
    """Phase 9's gen+disc and map steps with ``compute_dtype: bfloat16`` on
    the card (float32 master weights, the same batch, masks and windows)
    against phase 9's CPU float64 run, then the map step again from the
    float64 run's parameters before its map step (``map_from_f64``), where
    bf16's rounding in that step is all that differs. Gates: every logged
    loss within BF16_LOSS_REL x |ref| + BF16_LOSS_ABS; for the generator and
    the discriminator the gradient's cosine to float64's at least
    BF16_GRAD_COS and the parameter change's at least BF16_UPDATE_COS; for
    the map from float64's parameters, the cosine of its tensors from its
    last BatchNorm on (``after_last_batchnorm``) at least BF16_GRAD_COS;
    every training-mode BatchNorm call of both runs within BF16_NORM_ERR of
    float64 on its own input (``NormStatsCheck``); every step finite and
    moving its parameters. The whole map's cosines are reported, not gated:
    its BatchNorms normalise over four nearly equal global latents, and
    their backward leaves sound bf16 anywhere in 0.1-0.85 (PERF.md §6)."""
    import torch
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    deltas, names, checks = {}, {}, []

    def check_norms(task):
        checks.append(NormStatsCheck(task))
    bf, _ = train_step_runs(SVBVAEMleTask, (f32,), devices, sides=("bf16",), deltas=deltas,
                            on_task=check_norms, compute_dtype="bfloat16")
    sharp, _ = train_step_runs(SVBVAEMleTask, (f32,), devices, sides=("bf16",), names=names,
                               map_from=cpu64_state, on_task=check_norms,
                               compute_dtype="bfloat16")
    for c in checks:
        c.close()
    norm_err = {k: max(c.worst.get(k, 0.0) for c in checks) for c in checks for k in c.worst}
    ref_logs, ref_grads = runs["cpu", f64]
    logs, grads = bf["bf16", f32]
    over = {k: abs(logs[k] - v) / (BF16_LOSS_REL * abs(v) + BF16_LOSS_ABS)
            for k, v in ref_logs.items() if k in logs}
    groups = {}
    for group, ref in ref_grads.items():
        got, d_bf, d_ref = grads[group], deltas["bf16", f32][group], cpu64_deltas[group]
        groups[group] = dict(
            grad_cos=grad_cosine(got, ref), update_cos=grad_cosine(d_bf, d_ref),
            grad_l2_rel=math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(got, ref))
                                  / sum(float((b ** 2).sum()) for b in ref)),
            finite=all(bool(torch.isfinite(x).all()) for x in got + d_bf),
            moved=any(bool((x != 0).any()) for x in d_bf))
    got, ref, tail = sharp["bf16", f32][1]["map"], ref_grads["map"], after_last_batchnorm(names)
    groups["map_from_f64"] = dict(grad_cos=grad_cosine(got, ref),
                                  tail_grad_cos=grad_cosine(got[tail], ref[tail]),
                                  tail=names["map"][tail],
                                  finite=all(bool(torch.isfinite(x).all()) for x in got),
                                  moved=True)
    gated = ("gen", "disc")
    ok = (logs.keys() == ref_logs.keys() and max(over.values()) <= 1.0
          and all(g["finite"] and g["moved"] for g in groups.values())
          and all(groups[g]["grad_cos"] >= BF16_GRAD_COS
                  and groups[g]["update_cos"] >= BF16_UPDATE_COS for g in gated)
          and groups["map_from_f64"]["tail_grad_cos"] >= BF16_GRAD_COS
          and len(norm_err) > 0 and max(norm_err.values()) <= BF16_NORM_ERR)
    row = dict(ok=ok, frames=640, losses_over_tol=max(over.values()),
               loss_rel_err=loss_rel(logs, ref_logs), groups=groups,
               norm_err_max=max(norm_err.values(), default=None),
               norm_err_worst=max(norm_err, key=norm_err.get, default=None),
               norm_calls_checked=len(norm_err),
               tol=dict(loss_rel=BF16_LOSS_REL, loss_abs=BF16_LOSS_ABS, grad_cos=BF16_GRAD_COS,
                        update_cos=BF16_UPDATE_COS, map_tail_grad_cos=BF16_GRAD_COS,
                        norm_err=BF16_NORM_ERR),
               seconds=time.perf_counter() - t0)
    emit("bf16_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"bf16 card vs CPU float64: {row}")
    return row



def _faulty_batch_norm(kind):
    """A training-mode ``_batch_norm`` with fault ``kind`` planted."""
    import torch
    from neuralsvb_torch.models import common

    def bn_fn(x, bn):
        if not bn.training:
            return common._SOUND_BATCH_NORM(x, bn)
        shape = [1, -1] + [1] * (x.dim() - 2)
        out_dtype = x.dtype
        if kind == "sum_over_n":
            x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.dim()))
        if kind == "sum_over_n":
            n = x.numel() // x.shape[1]
            stats = torch.stack([x.sum(dims), (x * x).sum(dims)]) / n
        else:  # bf16_stats: x stays in its compute dtype
            stats = torch.stack([x.mean(dims), (x * x).mean(dims)])
        mean = stats[0].view(shape)
        var = (stats[1].view(shape) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean.detach().flatten().float(), alpha=m)
            bn.running_var.mul_(1 - m).add_(var.detach().flatten().float(), alpha=m)
            bn.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + bn.eps)
        return (y * bn.weight.view(shape).to(x.dtype)
                + bn.bias.view(shape).to(x.dtype)).to(out_dtype)
    return bn_fn


BF16_FAULTS = ("sum_over_n", "bf16_stats")


@contextlib.contextmanager
def planted(kind):
    """``neuralsvb_torch.models.common._batch_norm`` with fault ``kind``
    (None: the sound one) for the duration."""
    from neuralsvb_torch.models import common
    if not hasattr(common, "_SOUND_BATCH_NORM"):
        common._SOUND_BATCH_NORM = common._batch_norm
    common._batch_norm = (common._SOUND_BATCH_NORM if kind is None
                          else _faulty_batch_norm(kind))
    try:
        yield
    finally:
        common._batch_norm = common._SOUND_BATCH_NORM


def bf16_map_spread(argv):
    """The spread of phase 22's map-gradient cosine, for sound
    bf16 arithmetic and for planted faults.

    Phase 22 takes phase 9's gen + disc step and then the latent map's step of
    the flagship at ``compute_dtype: bfloat16`` on the card and holds the map
    gradient against the CPU's float64 gradient by its cosine. Two readings:

    - ``chained``: the map step follows the bf16 run's own generator step. That
      step is Adam's first, about lr x sign(g), so every gradient element near
      zero can flip the sign of its parameter's move between the two runs, and
      the map then starts from other parameters.
    - ``from_f64``: the map step starts from the float64 run's parameters and
      BatchNorm statistics before its map step (``train_step_runs(map_from=)``),
      so bf16's rounding in the map step is the only difference. Phase 22
      gates its ``_tail`` at ``BF16_GRAD_COS``.

    Each is also read over the map's tensors from its last BatchNorm on
    (``_tail``): the map's BatchNorms normalise over the batch's four global
    latents, and their backward amplifies rounding in the tensors before them.

    Each run also reads ``NormStatsCheck``: every training-mode
    BatchNorm call's output against float64 on the same input (``_norm_err``,
    the worst over modules and calls; phase 22 gates it at ``BF16_NORM_ERR``).

    Each reading is taken on the card for sound code, in bf16 on the CPU (the
    plain arithmetic), in float32 on the card, and on the card with a fault
    planted in the BatchNorm statistics (``BF16_FAULTS``; this process only, by
    replacing ``neuralsvb_torch.models.common._batch_norm``):

    - ``sum_over_n``: the statistics as ``x.sum / n`` where the port takes
      ``x.mean`` (a form tried during data-parallel work; float32 either way);
    - ``bf16_stats``: the statistics, normalisation and running-statistics
      update in bf16 where flax (and the port) take float32.

    Run from the repository root on a machine with a CUDA card:
    ``python3 chip_smoke.py --bf16-map-spread [--seeds 1234,1,2,...] [--repeats
    1] [--out FILE]`` (not part of the smoke run). It binarizes phase 6's
    synthetic pairs into ``build/bf16_map_spread/`` first, prints one JSON
    object per seed and a summary, and writes them to ``--out`` (default
    ``build/bf16_map_spread.json``)."""
    import argparse
    global WORK
    ap = argparse.ArgumentParser(prog="chip_smoke.py --bf16-map-spread")
    ap.add_argument("--seeds", default="1234,1,2,3,4,5")
    ap.add_argument("--repeats", type=int, default=1, help="sound card bf16 runs per seed")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bf16_map_spread.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    WORK = os.path.join(REPO, "build", "bf16_map_spread")
    tf32(False)
    if not os.path.isdir(os.path.join(WORK, "binarize", "binary")):
        os.makedirs(WORK, exist_ok=True)
        phase_binarize()
    f32, f64 = torch.float32, torch.float64
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout

    def readings(ref_grads, state, tail, device, fault=None, **over):
        """{'chained', 'from_f64'}: the map gradient's cosine, and with
        '_tail' that of its tensors from its last BatchNorm on; plus the
        generator's and discriminator's cosines of the chained run."""
        out = {}
        with planted(fault):
            for name, map_from in (("chained", None), ("from_f64", state)):
                checks = []
                run, _ = train_step_runs(SVBVAEMleTask, (f32,), (device,), sides=("x",),
                                            map_from=map_from,
                                            on_task=lambda t: checks.append(NormStatsCheck(t)),
                                            **over)
                worst = checks[0].worst
                checks[0].close()
                out[f"{name}_norm_err"] = max(worst.values())
                out[f"{name}_norm_worst"] = max(worst, key=worst.get)
                grads = run["x", f32][1]
                out[name] = grad_cosine(grads["map"], ref_grads["map"])
                out[f"{name}_tail"] = grad_cosine(grads["map"][tail], ref_grads["map"][tail])
                if map_from is None:
                    out["gen"] = grad_cosine(grads["gen"], ref_grads["gen"])
                    out["disc"] = grad_cosine(grads["disc"], ref_grads["disc"])
        return out

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        states, names = {}, {}
        ref, _ = train_step_runs(SVBVAEMleTask, (f64,), ("cpu",), sides=("cpu",),
                                    states=states, names=names, seed=seed)
        ref_grads, state = ref["cpu", f64][1], states["cpu", f64]
        tail = after_last_batchnorm(names)
        bf16 = dict(compute_dtype="bfloat16", seed=seed)
        row = {"seed": seed, "nvidia_smi": smi.strip(),
               "tail": names["map"][tail],
               "card_bf16": [readings(ref_grads, state, tail, "cuda", **bf16)
                             for _ in range(args.repeats)],
               "cpu_bf16": readings(ref_grads, state, tail, "cpu", **bf16),
               "card_f32": readings(ref_grads, state, tail, "cuda", seed=seed),
               # the same form in float32: a fault would show here too
               "card_f32_sum_over_n": readings(ref_grads, state, tail, "cuda", "sum_over_n",
                                               seed=seed)}
        for fault in BF16_FAULTS:
            row[f"card_bf16_{fault}"] = readings(ref_grads, state, tail, "cuda", fault, **bf16)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"gates": {"norm_err": BF16_NORM_ERR, "map_tail_from_f64": BF16_GRAD_COS},
               "nvidia_smi": smi.strip()}
    for reading in ("chained", "chained_tail", "chained_norm_err", "from_f64", "from_f64_tail",
                    "from_f64_norm_err"):
        sound = [r[reading] for row in rows for r in row["card_bf16"]]
        summary[reading] = {
            "card_bf16": sorted(sound),
            "cpu_bf16": sorted(row["cpu_bf16"][reading] for row in rows),
            "card_f32": sorted(row["card_f32"][reading] for row in rows),
            "card_f32_sum_over_n": sorted(row["card_f32_sum_over_n"][reading] for row in rows),
            **{f"card_bf16_{f}": sorted(row[f"card_bf16_{f}"][reading] for row in rows)
               for f in BF16_FAULTS}}
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"seeds": rows, "summary": summary}, f, indent=1)



def phase_accum_card_vs_cpu(devices=("cpu", "cuda")):
    """``accumulate_grad_batches: 2`` in float64 on the CPU and on the card
    from the same weights, phase 9's batch, masks and windows: micro-steps
    of the generator + discriminator (steps 1-2 on the CPU, 1-4 on the
    card). The parameters move only at even micro-steps; the card's
    micro-step gradients are within 1e-3 of each tensor's scale of the
    CPU's, and after micro-step 2 its parameters are within 1e-3 lr of the
    CPU's where the averaged gradient is settled (2 lr elsewhere: Adam's
    first step is about lr x sign(g))."""
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    f64 = torch.float64
    t0 = time.perf_counter()
    res = {}
    for side, dev, micro in (("cpu", devices[0], 2), ("card", devices[1], 4)):
        cfg = train_config(os.path.join(WORK, "voc"), device=dev, max_frames=640,
                           zero_noise=True, ds_workers=0, accumulate_grad_batches=2)
        hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
        with hparams_scope(hp):
            task = SVBVAEMleTask()
            task.build_model()
            task.build_train()
            task.model.to(f64)
            task.mel_disc.to(f64)
            task.rand_device = torch.device("cpu")
            task.disc_start_frames_wins = [100, 200, 300]
            grads = []
            task.grad_hook = lambda group, ps: grads.append(
                (group, [p.grad.detach().cpu().clone() for p in ps]))
            task.train_dataloader()
            ds = task._train_ds
            batch = ds.collater([ds[i] for i in range(len(ds))])
            params = list(task.gen_params) + list(task.disc_params)
            moved, lrs, after2 = [], [], None
            torch.set_default_dtype(f64)
            try:
                for step in range(1, micro + 1):
                    before = [p.detach().clone() for p in params]
                    logs = {}
                    for idx in (0, 1):
                        logs.update(task.training_step(batch, step, idx)[1])
                    moved.append(any(not torch.equal(p, b) for p, b in zip(params, before)))
                    lrs.append(max(float(logs["lr_0"]), float(logs["lr_1"])))
                    if step == 2:
                        after2 = [p.detach().cpu().clone() for p in params]
            finally:
                torch.set_default_dtype(torch.float32)
            res[side] = dict(moved=moved, grads=grads, after2=after2, lrs=lrs)
    cpu, card = res["cpu"], res["card"]
    worst = 0.0
    for (g1, a), (g2, b) in zip(cpu["grads"], card["grads"]):
        worst = max(worst, grads_over_scale(b, a, grad_scales(a)))
    # the averaged gradient of each parameter over the two micro-steps (CPU)
    n_gen = len(cpu["grads"][0][1])
    mean = [(x + y) / 2 for x, y in zip(cpu["grads"][0][1] + cpu["grads"][1][1],
                                          cpu["grads"][2][1] + cpu["grads"][3][1])]
    scales = grad_scales(mean[:n_gen]) + grad_scales(mean[n_gen:])
    lr = max(cpu["lrs"][:2])
    p_worst = 0.0
    for m, sc, a, b in zip(mean, scales, cpu["after2"], card["after2"]):
        tol = torch.where(m.abs() > 1e-3 * sc, torch.full_like(m, 1e-3 * lr),
                          torch.full_like(m, 2 * lr))
        p_worst = max(p_worst, float(((a - b).abs() / tol).max()))
    ok = (cpu["moved"] == [False, True] and card["moved"] == [False, True, False, True]
          and worst <= 1e-3 and p_worst <= 1.0)
    row = dict(ok=ok, frames=640, moved_cpu=cpu["moved"], moved_card=card["moved"],
               grads_over_scale=worst, params_over_tol=p_worst, lrs=card["lrs"],
               seconds=time.perf_counter() - t0)
    emit("accum_card_vs_cpu", **row)
    if not ok:
        raise AssertionError(f"accumulation card vs CPU: {row}")
    return row


def phase_bf16_vocoder(voc, device="cuda"):
    """One ``vocoder_compute_dtype: bfloat16`` vocoder call (seeded
    full-width HiFiGAN-NSF, a 2000-frame mel: the 2048 bucket) beside the
    float32 vocoder's: the bf16 wav within BF16_WAV_MEAN_REL /
    BF16_WAV_MAX_REL of the float32 wav's mean / max magnitude, its
    launches (18 x stages convs + one pre-pass per stage, counts zeroed just
    before the call) and both calls' median times over 5 warm calls."""
    import numpy as np
    import torch
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    T = 2000
    t = np.arange(T) * 128 / SR
    f0 = (220.0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))).astype(np.float32)
    mel = (np.random.RandomState(3).randn(T, voc["audio_num_mel_bins"]) - 4).astype(np.float32)
    row, wavs = {}, {}
    for name, cdt in (("f32", ""), ("bf16", "bfloat16")):
        vocoder = HifiGAN(dict(voc, vocoder_ckpt="", device=device, seed=7,
                               vocoder_denoise_c=0.0, vocoder_compute_dtype=cdt))

        def call():
            w = vocoder.spec2wav(mel, f0=f0, zero_noise=True)
            if device == "cuda":
                torch.cuda.synchronize()
            return w
        for c in fr.KERNEL_COUNTERS:
            c.launches = 0
        wavs[name] = call().cpu()
        row[f"{name}_launches"] = {c.__name__: c.launches for c in fr.KERNEL_COUNTERS}
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        row[f"{name}_call_ms"] = statistics.median(times) * 1e3
        row[f"{name}_call_ms_min_max"] = [min(times) * 1e3, max(times) * 1e3]
    d = (wavs["bf16"] - wavs["f32"]).abs()
    ref = wavs["f32"].abs()
    stages = len(voc["upsample_rates"])
    on_card = device == "cuda"
    want = {"resblock_conv1d_bf16": 18 * stages * on_card, "lrelu_bf16": stages * on_card,
            "resblock_conv1d": 0, "resblock_cluster_backward_cuda": 0}
    row.update(mean_rel=float(d.mean() / ref.mean()), max_rel=float(d.max() / ref.max()),
               finite=bool(torch.isfinite(wavs["bf16"]).all()), expected_launches=want,
               frames=T, bucket=2048)
    row["ok"] = (row["finite"] and row["mean_rel"] <= BF16_WAV_MEAN_REL
                 and row["max_rel"] <= BF16_WAV_MAX_REL and row["bf16_launches"] == want)
    emit("bf16_vocoder", **row)
    if not row["ok"]:
        raise AssertionError(f"bf16 vocoder: {row}")
    return row["bf16_launches"]


def _dp_worker(rank, world, init_file, cfg, out, device):
    """A spawned rank of phase 25: one gen+disc and one map step of the
    flagship at ``mesh_shape: data:2`` in float64 on the card, its rows of
    phase 9's batch; saves the losses, gradients and parameters."""
    sys.path.insert(0, REPO)
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.parallel import ddp
    ddp.init_process_group(device, backend="gloo", init_method=f"file://{init_file}",
                           world=world, rank_=rank)
    try:
        hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
        with hparams_scope(hp):
            torch.save(dp_steps(), f"{out}.{rank}")
        ddp.barrier()
    finally:
        ddp.destroy_process_group()


def dp_steps():
    """The flagship's gen+disc step (1) and map step (TRAIN_PHASE2 + 1) in
    float64 from the seed under the current hparams, the step's random
    draws live (posterior noise, dropout, windows, from the step's
    generator on the task's device); returns logs, gradients and
    parameters."""
    import torch
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    f64 = torch.float64
    task = SVBVAEMleTask()
    task.build_model()
    task.build_train()
    task.model.to(f64)
    task.mel_disc.to(f64)
    grads = {}
    task.grad_hook = lambda group, ps: grads.__setitem__(
        group, [p.grad.detach().cpu().clone() for p in ps])
    task.train_dataloader()
    ds = task._train_ds
    batch = ds.collater([ds[i] for i in range(len(ds))])
    logs = {}
    torch.set_default_dtype(f64)
    try:
        for step, idx in ((1, 0), (1, 1), (TRAIN_PHASE2 + 1, 2)):
            logs.update({f"{idx}/{k}": float(torch.as_tensor(v).detach()) for k, v in
                         task.training_step(batch, step, idx)[1].items()})
    finally:
        torch.set_default_dtype(torch.float32)
    return {"logs": logs, "grads": grads,
            "params": {k: v.detach().cpu().clone() for m in (task.model, task.mel_disc)
                       for k, v in m.state_dict().items()}}


def phase_data_parallel(voc, device="cuda:0"):
    """Data parallelism on the one card: two ranks over gloo on cuda:0.

    (a) In process: ``torch.multiprocessing.spawn`` starts two ranks
    (``_dp_worker``) that take a gen+disc step and a map step of the
    flagship at ``mesh_shape: data:2`` in float64 on phase 9's batch (four
    items cropped to 640 frames: two per rank), dropout and windows live;
    this process takes the same steps at ``data:1``. The ranks must agree
    bit for bit, and with the one process within 1e-6 relative (losses;
    gradients and parameters against each tensor's largest magnitude, at
    least 1e-3 of its group's), as ``tests/test_torch_ddp.py`` holds it on
    the CPU.

    (b) The user's entry point with every other training option on:
    ``torchrun --nproc_per_node 2 -m neuralsvb_torch.tasks.run`` at
    ``mesh_shape=data:2`` (both ranks on cuda:0, so the backend is gloo)
    over phase 6's packed splits twice (``binary_data_dirs``) with
    ``cache_ppg``, ``use_cond_disc`` and ``accumulate_grad_batches: 2``:
    2 steps with a validation at step 2 that rank 0 vocodes, then a resume
    to 3. Checks: the ranks' ``state_digest``s agree in both runs, every
    logged loss is finite, the PPG cache streams (the members' ids repeat),
    the step-2 checkpoint (rank 0's) holds the accumulators and no
    ``cond_disc`` tensors, the resume restores step 2 and ends at 3, and the
    validation launches 18 x stages + stages bf16 kernels per vocoder
    call. NCCL across cards is not tried: the machine has one card.
    Returns rank 0's launches in the first run."""
    import torch
    import torch.multiprocessing as mp
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    t0 = time.perf_counter()
    root = os.path.join(WORK, "dp")
    os.makedirs(root, exist_ok=True)
    cfg2 = train_config(os.path.join(WORK, "voc"), device=device, max_frames=640,
                        ds_workers=0, mesh_shape="data:2", name="dp2.yaml")
    cfg1 = train_config(os.path.join(WORK, "voc"), device=device, max_frames=640,
                        ds_workers=0, mesh_shape="", name="dp1.yaml")
    if os.path.exists(os.path.join(root, "pg")):
        os.remove(os.path.join(root, "pg"))
    mp.spawn(_dp_worker, args=(2, os.path.join(root, "pg"), cfg2, os.path.join(root, "out"),
                               device), nprocs=2)
    ranks = [torch.load(os.path.join(root, f"out.{r}"), weights_only=False) for r in (0, 1)]
    with hparams_scope(set_hparams(config=cfg1, print_hparams=False, global_hparams=False)):
        one = dp_steps()
    ranks_equal = all(
        torch.equal(a, b) for a, b in zip(ranks[0]["params"].values(),
                                          ranks[1]["params"].values())) and all(
        torch.equal(a, b) for g in ranks[0]["grads"]
        for a, b in zip(ranks[0]["grads"][g], ranks[1]["grads"][g]))
    loss_worst = max(abs(ranks[0]["logs"][k] - v) / max(abs(v), 1e-12)
                     for k, v in one["logs"].items())
    worst = {}
    for what, got, want in (
            [("params", ranks[0]["params"], one["params"])]
            + [(f"grad.{g}", dict(enumerate(ranks[0]["grads"][g])), dict(enumerate(one["grads"][g])))
               for g in one["grads"]]):
        big = max(float(v.abs().max()) for v in want.values() if v.is_floating_point())
        w = 0.0
        for k, v in want.items():
            if v.is_floating_point():
                scale = max(float(v.abs().max()), 1e-3 * big, 1e-30)
                w = max(w, float((got[k] - v).abs().max()) / scale)
        worst[what] = w
    in_process_ok = (ranks_equal and loss_worst <= 1e-6 and max(worst.values()) <= 1e-6
                     and ranks[0]["logs"].keys() == one["logs"].keys())

    # (b) the CLI under torchrun, with every other training option on
    binary = os.path.join(WORK, "binarize", "binary")
    cli = train_config(os.path.join(WORK, "voc"), device=device, mesh_shape="data:2",
                       binary_data_dirs=[binary, binary], cache_ppg=True,
                       use_cond_disc=True, accumulate_grad_batches=2, max_updates=2,
                       val_check_interval=2, valid_infer_interval=2, num_sanity_val_steps=0,
                       name="dp_cli.yaml")
    work = os.path.join(root, "cli_work")
    shutil.rmtree(work, ignore_errors=True)

    def torchrun(hp=""):
        # --standalone: a rendezvous on a free local port
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "neuralsvb_torch.tasks.run", "--config", cli,
               "--hparams", f"work_dir={work}{hp}"]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        by_rank = {s["rank"]: s for s in (json.loads(m.group(1)) for m in re.finditer(
            r"^\| train summary: (\{.*\})$", proc.stdout, re.M))}
        return proc.stdout, by_rank, time.perf_counter() - t1
    out, by_rank, cli_wall = torchrun()
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out, re.M)}
    stages = len(voc["upsample_rates"])
    main = by_rank.get(0, {})
    calls = main.get("vocoder_calls", -1)
    on_card = device.startswith("cuda")  # CPU tensors take the plain cluster
    want = {"resblock_conv1d_bf16_launches": 18 * stages * calls * on_card,
            "lrelu_bf16_launches": stages * calls * on_card, "resblock_conv1d_launches": 0}
    launches = {k: main.get(k) for k in want}
    ckpt = torch.load(os.path.join(work, "model_ckpt_steps_2.ckpt"), map_location="cpu",
                      weights_only=True)
    resumed, by_rank3, resume_wall = torchrun(",max_updates=3")

    def ranks_agree(runs):
        return (set(runs) == {0, 1} and all(r["world"] == 2 for r in runs.values())
                and runs[0]["state_digest"] == runs[1]["state_digest"])
    cli = dict(
        ranks_agree=ranks_agree(by_rank) and ranks_agree(by_rank3),
        streams="PPG cache: the train items' ids are not global indices" in out,
        finite=sorted(steps) == [1, 2] and all(math.isfinite(v) for lg in steps.values()
                                              for v in lg.values()),
        accumulators={g: a["mini_step"] for g, a in ckpt["accumulators"].items()},
        cond_disc_tensors=[k for k in ckpt["state_dict"]["mel_disc"]
                           if k.startswith("cond_disc")],
        resumed=(by_rank3.get(0, {}).get("start_step"), by_rank3.get(0, {}).get("end_step")),
        restored="model_ckpt_steps_2.ckpt" in resumed, vocoder_calls=calls,
        wall_s=cli_wall, resume_wall_s=resume_wall,
        step_s=main.get("phases"), last_step_losses=steps.get(2))
    # the discriminator starts after step 0: the step-2 checkpoint holds it
    # in the middle of its accumulation
    cli_ok = (cli["ranks_agree"] and cli["streams"] and cli["finite"]
              and cli["accumulators"] == {"gen": 0, "disc": 1, "map": 0}
              and not cli["cond_disc_tensors"] and cli["resumed"] == (2, 3)
              and cli["restored"] and calls > 0 and launches == want)
    row = dict(ok=in_process_ok and cli_ok, backend="gloo", world=2, device=device,
               ranks_bit_identical=ranks_equal, loss_rel_worst=loss_worst,
               over_scale_worst=worst, cli_ok=cli_ok, cli=cli, cli_launches=launches,
               cli_expected_launches=want, seconds=time.perf_counter() - t0,
               nccl_multi_card="not tried: one card on this machine")
    emit("data_parallel", **row)
    if not row["ok"]:
        raise AssertionError(f"data parallel: {row}")
    return launches


# ---------------------------------------------------------------------------
# the FastSpeech2 family and the evaluation harnesses (phases 26-31)
# ---------------------------------------------------------------------------

FS2_RECIPE = "egs/egs_bases/tts/fs2_adv_torch.yaml"
FS2_SPEAKERS, FS2_UTTS, FS2_TEST_NUM = 2, 12, 4
FS2_STEPS, FS2_RESUME, FS2_VAL_EVERY = 4, 6, 2
FS2_GEN_KEYS = {"l1", "ssim", "pdur", "sdur", "f0", "uv", "a", "lr_0"}
FS2_DISC_KEYS = {"r", "f", "lr_1"}
FS2_CARD_VS_CPU = dict(items=3, frames=320, starts=[40, 80, 120])
FS2_CWT = "pitch_type=cwt,lambda_f0=1.0,cwt_add_f0_loss=true"
MCD_GATE_DB = 0.1  # BASELINE.md:30, the a2p parity metric
ALIGNERS = ("SADTW", "EHSADTW", "NaiveDTW", "ZMNaiveDTW", "NNaiveDTW", "LoNDTW")


def fs2_config(device="cuda", name="fs2.yaml", **over):
    """``fs2_adv_torch.yaml`` at the recipe's full width (hidden 256, 4 + 4
    FFT/conv layers, 2 heads, the multi-window discriminator 3 x 128) on
    phase 26's corpus, binarized with ``with_f0cwt`` as well."""
    import yaml
    root = os.path.join(WORK, "fs2")
    cfg = os.path.join(WORK, name)
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(REPO, FS2_RECIPE)],
            "processed_data_dir": os.path.join(root, "processed"),
            "binary_data_dir": os.path.join(root, "binary"), "device": device,
            "binarization_args": {"with_f0cwt": True}, "test_num": FS2_TEST_NUM,
            "ds_workers": 1, "max_updates": FS2_STEPS, "val_check_interval": FS2_VAL_EVERY,
            "num_sanity_val_steps": 1, "tb_log_interval": 1}, **over), f)
    return cfg


def phase_fs2_binarize(device="cuda"):
    """2 speakers x 12 utterances of 2-6 s with transcripts and TextGrids
    through ``python -m neuralsvb_torch.data.binarize`` with the FS2 recipe;
    returns its config."""
    import numpy as np
    from neuralsvb_torch.data.synthetic import write_synthetic_speech_corpus
    write_synthetic_speech_corpus(os.path.join(WORK, "fs2", "processed"), FS2_SPEAKERS,
                                  FS2_UTTS, textgrids=True)
    cfg = fs2_config(device)
    wall, summary = run_binarize(cfg, device)
    binary = os.path.join(WORK, "fs2", "binary")
    bad, n_items = [], {}
    for prefix in ("train", "valid", "test"):
        items = read_split(binary, prefix)
        n_items[prefix] = len(items)
        for it in items:
            T = len(it["mel"])
            if not (it["mel2ph"].shape == (T,) and it["mel2ph"].max() < len(it["phone"])
                    and it["cwt_spec"].shape == (T, 10) and np.isfinite(it["cwt_spec"]).all()
                    and len(it["ph2word"]) == len(it["phone"]) and (it["f0"] > 0).mean() > 0.5):
                bad.append(f"{it['item_name']}: mel2ph/cwt_spec/ph2word/f0")
    want = {"train": FS2_SPEAKERS * FS2_UTTS - FS2_TEST_NUM, "valid": FS2_TEST_NUM,
            "test": FS2_TEST_NUM}
    if n_items != want or summary["items"] != want:
        bad.append(f"items {n_items} {summary['items']} != {want}")
    emit("fs2_binarize", ok=not bad, problems=bad, wall_s=wall, items=n_items,
         summary=summary)
    if bad:
        raise AssertionError(f"fs2 binarize: {bad}")
    return cfg


def wav_frames_check(gen_dir, frames, kinds):
    """Each kind's wavs are frames x 128 samples long, finite and not
    silent; returns the problems."""
    import numpy as np
    bad = []
    for kind in kinds:
        wavs = sorted(glob.glob(f"{gen_dir}/wavs/{kind}/*.wav"))
        lens = []
        for wf in wavs:
            with wave.open(wf) as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            lens.append(pcm.shape[0])
            if np.sqrt(np.mean(pcm.astype(np.float64) ** 2)) < 1.0:
                bad.append(f"{wf} is silent")
        if sorted(lens) != sorted(f * 128 for f in frames):
            bad.append(f"{kind}: {sorted(lens)} samples for {sorted(frames)} frames")
    return bad


def phase_fs2_train(cfg, voc, pwg_work, device="cuda"):
    """``FastSpeech2AdvTask`` at full width: 4 steps (the discriminator from
    step 1, validating at 0, 2 and 4), a resume to 6, then ``--infer`` with
    the recipe's PWG (phase 14's trained hop-128 model: no kernel of the
    repo) and with HiFiGAN-NSF (``vocoder_keys``, seeded: the bf16 ResBlock
    kernel, 54 + 3 launches per vocoder call, a P and a G call per item).
    Returns the HiFiGAN ``--infer`` process's launches."""
    import math
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.fs2_adv import FastSpeech2AdvTask
    work = os.path.join(WORK, "fs2_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={FS2_RESUME}",
                                         in_process=True)
    rs = summary_of(resumed, "train")
    bad = []
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out + resumed, re.M)}
    for n, logs in steps.items():  # "step n" logs step n - 1
        want = FS2_GEN_KEYS | FS2_DISC_KEYS if n > 1 else FS2_GEN_KEYS - {"a"}
        if set(logs) - {"total_loss_0", "total_loss_1"} != want:
            bad.append(f"step {n} logs {sorted(logs)}")
        if not all(math.isfinite(v) for v in logs.values()):
            bad.append(f"step {n}: non-finite {logs}")
    if sorted(steps) != list(range(1, FS2_RESUME + 1)):
        bad.append(f"logged steps {sorted(steps)}")
    valid = re.findall(r"^\| Valid results: (\{.*\})$", out, re.M)
    if len(valid) != FS2_STEPS // FS2_VAL_EVERY + 1:
        bad.append(f"validations {valid}")
    if (rs["start_step"], rs["end_step"]) != (FS2_STEPS, FS2_RESUME):
        bad.append(f"resume {rs['start_step']} -> {rs['end_step']}")
    if any(v for k, v in {**s, **rs}.items() if k.endswith("_launches")):
        bad.append("a kernel of the repo launched in training")  # PWG vocodes validation
    hp = set_hparams(config=cfg, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    with hparams_scope(hp):
        init = FastSpeech2AdvTask()
        init.build_model()
        init.build_train()
    c = torch.load(os.path.join(work, f"model_ckpt_steps_{FS2_STEPS}.ckpt"),
                   map_location="cpu", weights_only=True)["state_dict"]
    moved = changed(init.model.state_dict(), c["model"])
    invariants = {part: any(k.startswith(f"{part}.") for k in moved)
                  for part in ("encoder", "decoder", "dur_predictor", "pitch_predictor",
                               "mel_out")}
    invariants["disc"] = bool(changed(init.mel_disc.state_dict(), c["mel_disc"]))
    test_frames = [len(it["mel"]) for it in read_split(os.path.join(WORK, "fs2", "binary"),
                                                       "test")]
    infers = {}
    for name, ckpt in (("PWG", pwg_work), ("HifiGAN", os.path.join(WORK, "voc"))):
        io, iwall = run_train_cli(cfg, work, "--infer", hp=f",vocoder={name},vocoder_ckpt="
                                  f"{ckpt},gen_dir_name={name}", in_process=True)
        summary = summary_of(io, "infer")
        gen = os.path.join(work, f"generated_{FS2_RESUME}_{name}")
        problems = wav_frames_check(gen, test_frames, ("p_wavout", "g_wavout"))
        mels = sorted(glob.glob(f"{gen}/mels/mel/*.npy"))
        plots = glob.glob(f"{gen}/plot/*.npy")
        if len(mels) != FS2_TEST_NUM or len(plots) != FS2_TEST_NUM:
            problems.append(f"{len(mels)} mels, {len(plots)} f0 tracks")
        calls = 2 * FS2_TEST_NUM
        stages = len(voc["upsample_rates"])
        on_card = device == "cuda"
        want = ({"resblock_conv1d_bf16": 18 * stages * calls * on_card,
                 "lrelu_bf16": stages * calls * on_card, "resblock_conv1d": 0}
                if name == "HifiGAN" else
                {"resblock_conv1d_bf16": 0, "lrelu_bf16": 0, "resblock_conv1d": 0})
        launches = {k: summary[f"{k}_launches"] for k in want}
        if launches != want or summary["vocoder_calls"] != calls:
            problems.append(f"launches {launches} != {want}, calls {summary['vocoder_calls']}")
        infers[name] = dict(ok=not problems, problems=problems, in_process_wall_s=iwall,
                            launches=launches, expected_launches=want, summary=summary)
    ok = not bad and all(invariants.values()) and all(r["ok"] for r in infers.values())
    row = dict(ok=ok, problems=bad, invariants=invariants, wall_s=wall,
               resume_in_process_wall_s=wall_resume, summary=s, resume_summary=rs,
               validations=valid, last_step_losses=steps.get(FS2_RESUME), infer=infers)
    emit("fs2_train", **row)
    print(f"| train summary: {json.dumps(s)}", flush=True)
    if not ok:
        raise AssertionError(f"fs2 train: {bad} {invariants} {infers}")
    return infers["HifiGAN"]["launches"]


def phase_fs2_step_time():
    """``scripts/train_profile.py`` on the FS2 recipe: warm generator +
    discriminator steps at its token budget (30 x 1000 frames, 85 tokens
    each)."""
    out = os.path.join(WORK, "fs2_profile.json")
    proc = subprocess.run([sys.executable, "scripts/train_profile.py", "--config", FS2_RECIPE,
                           "--out", out, "--warm", "5"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"train_profile failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out) as f:
        res = json.load(f)[0]
    warm, prof = res["phase2_warm_steps_s"], res["profiled_phase2_step"]
    row = dict(batch=res["batch"], first_step_s=res["phase2_first_step_s"], warm_steps_s=warm,
               median_s=res["phase2_median_s"], min_s=min(warm), max_s=max(warm),
               max_memory_allocated=res["max_memory_allocated"],
               profiled_step={k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                   "busy_share_of_unprofiled_median",
                                                   "merged_busy_ms", "merged_busy_share",
                                                   "merged_busy_share_of_unprofiled_median",
                                                   "launches", "by_kind_ms")},
               top_kernels=prof["top_kernels"][:10], nvidia_smi=res["nvidia_smi"])
    emit("fs2_step_time", **row)
    return row


def fs2_step_runs(cfg, extra, steps, devices):
    """Generator + discriminator steps of the seeded full-width
    ``FastSpeech2AdvTask`` on the CPU and on the card, in float32 and
    float64 from the same float32 weights, on three train items cropped to
    320 frames, with pinned discriminator windows and the same dropout masks
    (drawn on the CPU). Returns ({(side, dtype): (losses, last gradients)},
    parameter names)."""
    import torch
    from neuralsvb_torch.data.datasets import FastSpeechDataset
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.fs2_adv import FastSpeech2AdvTask
    runs = {}
    for dtype in (torch.float32, torch.float64):
        for side, dev in zip(("cpu", "card"), devices):
            hp = set_hparams(config=cfg, hparams_str=f"device={dev},max_frames="
                             f"{FS2_CARD_VS_CPU['frames']},{extra}", print_hparams=False,
                             global_hparams=False)
            with hparams_scope(hp):
                ds = FastSpeechDataset("train")  # sets f0_mean/f0_std, as training does
                task = FastSpeech2AdvTask()
                task.build_model()
                task.build_train()
                task.model.to(dtype)
                task.mel_disc.to(dtype)
                task.rand_device = torch.device("cpu")
                task.disc_start_frames_wins = FS2_CARD_VS_CPU["starts"]
                grads = {}
                task.grad_hook = lambda group, params: grads.__setitem__(
                    group, [p.grad.detach().cpu().double().clone() for p in params])
                names = {"gen": [n for n, _ in task.model.named_parameters()],
                         "disc": [n for n, _ in task.mel_disc.named_parameters()]}
                batch = ds.collater([ds[i] for i in range(FS2_CARD_VS_CPU["items"])])
                torch.set_default_dtype(dtype)
                try:
                    logs = {}
                    for step in steps:
                        for idx in (0, 1):
                            logs.update({f"{step}/{idx}/{k}": float(torch.as_tensor(v).detach())
                                         for k, v in task.training_step(batch, step, idx)[1]
                                         .items()})
                finally:
                    torch.set_default_dtype(torch.float32)
                runs[side, dtype] = logs, grads
    return runs, names


def phase_fs2_card_vs_cpu(cfg, devices=("cpu", "cuda")):
    """The recipe (frame pitch, conv decoder) one step, and ``pitch_type:
    cwt`` with ``cwt_add_f0_loss`` two steps, card vs CPU (``fs2_step_runs``,
    TF32 off). Gates, as phase 19's: every logged loss within 1e-4 relative
    in float64, and the first step's in float32; the last step's gradients,
    per tensor, card against CPU in float64 within 1e-3 of the tensor's
    scale; the float32 differences are printed beside them. A float32
    second step starts from parameters that the first step's float32
    gradients moved apart (the discriminator's is ill-conditioned: 0.13 of
    its scale from float64 on the card, 0.0014 on the CPU), so its losses
    are printed, not gated."""
    import torch
    f32, f64 = torch.float32, torch.float64
    rows, ok = {}, True
    for name, extra, steps in (("frame", "", (1,)), ("cwt", FS2_CWT, (1, 2))):
        t0 = time.perf_counter()
        runs, names = fs2_step_runs(cfg, extra, steps, devices)
        rel32_all = loss_rel(runs["card", f32][0], runs["cpu", f32][0])
        rel32 = {k: v for k, v in rel32_all.items() if k.startswith(f"{steps[0]}/")}
        rel64 = loss_rel(runs["card", f64][0], runs["cpu", f64][0])
        good = max(rel32.values()) <= 1e-4 and max(rel64.values()) <= 1e-4
        groups = {}
        for group in ("gen", "disc"):
            scales = grad_scales(runs["cpu", f64][1][group])
            g = {(side, dt): runs[side, dt][1][group] for side in ("cpu", "card")
                 for dt in (f32, f64)}
            off = [float((x - y).abs().max()) / sc
                   for x, y, sc in zip(g["card", f32], g["cpu", f64], scales)]
            groups[group] = dict(
                card_vs_cpu_f64=grads_over_scale(g["card", f64], g["cpu", f64], scales),
                card_vs_cpu_f32=grads_over_scale(g["card", f32], g["cpu", f32], scales),
                card_f32_vs_f64=grads_over_scale(g["card", f32], g["cpu", f64], scales),
                cpu_f32_vs_f64=grads_over_scale(g["cpu", f32], g["cpu", f64], scales),
                card_f32_worst_tensor=names[group][off.index(max(off))])
            good = good and groups[group]["card_vs_cpu_f64"] <= 1e-3
        rows[name] = dict(ok=good, steps=list(steps), max_loss_rel_err_f32=max(rel32.values()),
                          max_loss_rel_err_f64=max(rel64.values()),
                          loss_rel_err_f32_all_steps=rel32_all, grads_over_scale=groups,
                          losses_cpu_f32=runs["cpu", f32][0], seconds=time.perf_counter() - t0)
        ok = ok and good
    emit("fs2_card_vs_cpu", ok=ok, items=FS2_CARD_VS_CPU["items"],
         frames=FS2_CARD_VS_CPU["frames"], tol_loss=1e-4, tol_grad_f64=1e-3, **rows)
    if not ok:
        raise AssertionError(f"fs2 card vs CPU: {rows}")
    return rows


def run_module(module, *args, timeout=900):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_pitch_alignment(cfgs, devices=("cuda", "cpu")):
    """``python -m neuralsvb_torch.tasks.pitch_alignment_task`` over phase
    6's test split with all six aligners, on the card and on the CPU. The
    χ² kernel launches once per item for SADTW and for EHSADTW on the card
    (none for the host aligners); the four host aligners' accuracies equal
    the CPU's; SADTW's and EHSADTW's differences are reported (an ulp of the
    χ² cost can flip a DP tie). Returns the card run's χ² launches."""
    runs = {}
    for dev in devices:
        out, wall = run_module("neuralsvb_torch.tasks.pitch_alignment_task", "--config",
                               cfgs["para_bin_torch"], "--hparams",
                               f"align_funcs={'|'.join(ALIGNERS)},align_split=test,device={dev}")
        acc = {m.group(1): dict(avg=float(m.group(2)), max=float(m.group(3)),
                                min=float(m.group(4)), bad=int(m.group(5)))
               for m in re.finditer(r"^\| (\w+) \[test\] avg=(\S+) max=(\S+) min=(\S+) "
                                    r"bad\(<0\.3\)=(\d+)$", out, re.M)}
        runs[dev] = dict(accuracies=acc, summary=summary_of(out, "pitch alignment"), wall_s=wall)
    card, cpu = (runs[d] for d in devices)
    items = card["summary"]["items"]
    launches = {a: card["summary"][a]["chi2_dist_launches"] for a in ALIGNERS}
    on_card = devices[0].startswith("cuda")
    want = {a: items * on_card if a in ("SADTW", "EHSADTW") else 0 for a in ALIGNERS}
    host_equal = all(card["accuracies"].get(a) == cpu["accuracies"].get(a)
                     for a in ALIGNERS[2:])
    diffs = {a: {k: card["accuracies"][a][k] - cpu["accuracies"][a][k]
                 for k in ("avg", "max", "min", "bad")} for a in ("SADTW", "EHSADTW")}
    ok = (sorted(card["accuracies"]) == sorted(ALIGNERS) and launches == want and host_equal
          and items == 4)
    emit("pitch_alignment", ok=ok, items=items, chi2_launches=launches,
         expected_launches=want, host_aligners_equal=host_equal, card_minus_cpu=diffs,
         seconds_per_item={a: card["summary"][a]["seconds"] / items for a in ALIGNERS},
         seconds_per_item_cpu={a: cpu["summary"][a]["seconds"] / items for a in ALIGNERS},
         card=card, cpu=cpu)
    if not ok:
        raise AssertionError(f"pitch alignment: {launches} {want} {host_equal} {runs}")
    return launches["SADTW"] + launches["EHSADTW"]


def phase_mcd(devices=("cuda", "cpu")):
    """The main path's ``--infer`` (phase 4's config) on one test utterance
    at zero noise, on the card and on the CPU; ``python -m
    neuralsvb_torch.tasks.mcd_eval`` between their a2p mels, gated at 0.1 dB
    (BASELINE.md's parity metric)."""
    dirs = {}
    for i, dev in enumerate(devices):
        work = os.path.join(WORK, f"mcd_{i}_{dev}")
        cmd = ["--config", os.path.join(WORK, "infer.yaml"), "--infer", "--hparams",
               f"work_dir={work},device={dev},zero_noise=true,num_test_samples=1"]
        out, wall = run_module("neuralsvb_torch.tasks.run", *cmd)
        dirs[i] = (os.path.join(work, "generated_0_", "mels", "a2p_mel"), wall)
    out, _ = run_module("neuralsvb_torch.tasks.mcd_eval", "--dir_a", dirs[0][0],
                        "--dir_b", dirs[1][0])
    m = re.search(r"^\| mean MCD over (\d+) items: (\S+) dB$", out, re.M)
    n, mcd = int(m.group(1)), float(m.group(2))
    import numpy as np
    from neuralsvb_torch.utils.metrics import mel_cepstral_distortion
    exact = [mel_cepstral_distortion(np.load(f), np.load(os.path.join(dirs[1][0],
                                                                     os.path.basename(f))))
             for f in sorted(glob.glob(os.path.join(dirs[0][0], "*.npy")))]
    ok = n >= 1 and mcd <= MCD_GATE_DB
    emit("mcd", ok=ok, items=n, mcd_db=mcd, mcd_db_unrounded=exact, gate_db=MCD_GATE_DB,
         lines=out.splitlines(),
         card_infer_wall_s=dirs[0][1], cpu_infer_wall_s=dirs[1][1])
    if not ok:
        raise AssertionError(f"MCD card vs CPU {mcd} dB over {n} items > {MCD_GATE_DB}")
    return mcd


# ---------------------------------------------------------------------------
# the SVBPara family and the serving leftovers (phases 32-34)
# ---------------------------------------------------------------------------

PARA_TASKS = ("ParaPPGConstraintTask", "ParaPPGPreExpTask", "ParaAlignedPPGTask",
              "ParaPPGPretrainedTask", "ParaPPGSpkConsistentTask", "AmtSpkTask")
PARA_PRETRAINED = ("ParaPPGPretrainedTask", "ParaPPGSpkConsistentTask", "AmtSpkTask")
# name -> (task class, hparams): the six subclasses and SVBParaTask's two
# model options; AmtSpkTask runs without energy, its JAX task's only setting
PARA_CONFIGS = dict(
    {name: (name, {"use_energy": False} if name == "AmtSpkTask" else {})
     for name in PARA_TASKS},
    ref_attn=("SVBParaTask", {"ref_attn": True}),
    conv_asr=("SVBParaTask", {"asr_enc_type": "conv"}))
PARA_CLI_TASK = "ParaPPGSpkConsistentTask"
PARA_STEPS, PARA_RESUME = 4, 6
PARA_CARD_VS_CPU = dict(items=2, frames=192, starts=[20, 40, 60])
PARA_TOKENS = (4, 5, 6, 7, 0, 0)  # injected phones (tests/test_tasks2.py:283-284)


def para_config(vc_work, device="cuda", name="svb_para.yaml", **over):
    """The ASR pre-training recipe's full widths (``vc_ppg_torch.yaml``:
    hidden 256, two conformer and two ASR decoder layers, four decoder conv
    layers, discriminator 3 windows x 128 channels) on phase 6's para splits
    with phase 16's phone set (so the ASR's token table is phase 17's),
    ``pretrain_asr_ckpt`` at phase 17's work dir, vocoded through the
    registry's HiFiGAN-NSF (phase 4's generator keys)."""
    import yaml
    root = os.path.join(WORK, "svb_para_bin")
    if not os.path.isdir(root):
        os.makedirs(root)
        src = os.path.join(WORK, "binarize", "binary")
        for f in os.listdir(src):
            os.symlink(os.path.join(src, f), os.path.join(root, f))
        shutil.copy(os.path.join(WORK, "vcppg", "binary", "phone_set.json"), root)
    cfg = os.path.join(WORK, name)
    with open(cfg, "w") as f:
        yaml.safe_dump(dict({
            "base_config": [os.path.join(REPO, VC_RECIPE)],
            "binary_data_dir": root, "device": device, "pretrain_asr_ckpt": vc_work,
            "vocoder": "HifiGAN", "vocoder_ckpt": os.path.join(WORK, "voc"),
            "ds_workers": 0, "disc_start_steps": 0, "max_updates": PARA_STEPS,
            "val_check_interval": PARA_STEPS, "valid_infer_interval": PARA_STEPS,
            "num_sanity_val_steps": 1, "num_valid_plots": 1, "tb_log_interval": 1},
            **over), f)
    return cfg


def para_task(cls_name, cfg_over, vc_work, device, **over):
    """A built and trainable SVBPara task of ``PARA_CONFIGS``' kind."""
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks import svb_para
    cfg = para_config(vc_work, device=device, name=f"para_{device.replace(':', '')}.yaml",
                      **dict(cfg_over, **over))
    hp = set_hparams(config=cfg, print_hparams=False, global_hparams=False)
    with hparams_scope(hp):
        task = getattr(svb_para, cls_name)()
        task.build_model()
        task.build_train()
    return task, hp


def para_expected_keys(task, tokens):
    """The generator's and the discriminator's log keys of ``task``."""
    ways = task.concurrent_ways
    gen = {f"{k}{w}" for k in task.loss_and_lambda for w in ways} | {"lr_0"}
    gen |= {f"{w}_{d}a" for w in ways for d in task.discriminators}
    disc = {f"{w}_{d}{x}" for w in ways for d in task.discriminators for x in "rf"} | {"lr_1"}
    if tokens and type(task).__name__ not in PARA_PRETRAINED:
        gen |= {"asr_a", "asr_p"}
    if tokens and type(task).__name__ == "ParaPPGConstraintTask":
        gen |= {"ppg_constraint"}
    return gen, disc


def phase_svb_para(voc, vc_work, device="cuda"):
    """The SVBPara family at full width on the card.

    (a) In this process, every configuration of ``PARA_CONFIGS`` takes two
    generator + discriminator steps (steps 1 and 2, the discriminators on)
    on the task's first train batch (phones injected for the constraint
    task, whose batches have none). Checks: every loss finite, with the
    task's keys (``_spk`` ones for the speaker-consistency task); every
    discriminator changed; the three pretrained tasks' ASR equal to phase
    17's checkpoint bit for bit after the steps.

    (b) The CLI (``task_cls`` on the recipe) for ``ParaPPGSpkConsistentTask``:
    train 4 steps (validating and vocoding at 0 and 4), resume to 6,
    ``--infer`` the test split through HiFiGAN-NSF: ``gt_a``, ``gt_p`` and
    every way per item, frames x 128 samples, not silent; the bf16 ResBlock
    kernel launches 18 x stages convs and one pre-pass per stage per vocoder
    call, in training and in ``--infer``. Returns the ``--infer`` launches."""
    import math
    import numpy as np
    import torch
    from neuralsvb_torch.convert.checkpoint import newest_checkpoint
    from neuralsvb_torch.hparams import hparams_scope
    t0 = time.perf_counter()
    vc = torch.load(newest_checkpoint(vc_work), map_location="cpu",
                    weights_only=True)["state_dict"]["model"]
    rows, bad = {}, []
    for name, (cls_name, over) in PARA_CONFIGS.items():
        t1 = time.perf_counter()
        task, hp = para_task(cls_name, over, vc_work, device)
        with hparams_scope(hp):
            batch = next(iter(task.train_dataloader()))
            tokens = cls_name == "ParaPPGConstraintTask"
            if tokens:
                batch["txt_tokens"] = np.tile(np.asarray(PARA_TOKENS), (batch["nsamples"], 1))
            discs0 = {d: {k: v.detach().clone() for k, v in m.state_dict().items()}
                      for d, m in task.discriminators.items()}
            logs = []
            for step in (1, 2):
                for idx in (0, 1):
                    out = task.training_step(batch, step, idx)
                    logs.append({k: float(torch.as_tensor(v).detach())
                                 for k, v in out[1].items()})
            if device.startswith("cuda"):
                torch.cuda.synchronize()
        want_gen, want_disc = para_expected_keys(task, tokens)
        problems = []
        for i, lg in enumerate(logs):
            want = want_gen if i % 2 == 0 else want_disc
            if set(lg) != want:
                problems.append(f"log {i} keys {sorted(set(lg) ^ want)}")
            if not all(math.isfinite(v) for v in lg.values()):
                problems.append(f"log {i} non-finite")
        unchanged = [d for d, m in task.discriminators.items() if not changed(discs0[d],
                                                                              m.state_dict())]
        if unchanged:
            problems.append(f"discriminators unchanged: {unchanged}")
        if cls_name in PARA_PRETRAINED:
            asr = {k: v for k, v in task.model.state_dict().items() if k.startswith("vc_asr.")}
            differ = [k for k, v in asr.items() if not torch.equal(v.cpu(), vc[k])]
            if not asr or differ:
                problems.append(f"frozen ASR differs from phase 17's: {differ[:5]}")
        rows[name] = dict(ok=not problems, problems=problems, task=cls_name, over=over,
                          batch=list(batch["mels"].shape[:2]),
                          discriminators=list(task.discriminators),
                          last_losses=logs[-2], seconds=time.perf_counter() - t1)
        bad += [f"{name}: {p}" for p in problems]
        del task
    in_process_s = time.perf_counter() - t0

    # (b) the CLI
    stages = len(voc["upsample_rates"])
    on_card = device.startswith("cuda")

    def want(calls):
        return {"resblock_conv1d_bf16_launches": 18 * stages * calls * on_card,
                "lrelu_bf16_launches": stages * calls * on_card, "resblock_conv1d_launches": 0}
    cfg = para_config(vc_work, device=device, name="para_cli.yaml",
                      task_cls=f"neuralsvb_torch.tasks.svb_para.{PARA_CLI_TASK}")
    work = os.path.join(WORK, "para_cli_work")
    out, wall = run_train_cli(cfg, work)
    s = summary_of(out, "train")
    resumed, wall_resume = run_train_cli(cfg, work, hp=f",max_updates={PARA_RESUME}",
                                         in_process=True)
    rs = summary_of(resumed, "train")
    infer, wall_infer = run_train_cli(cfg, work, "--infer", in_process=True)
    isum = summary_of(infer, "infer")
    steps = {int(m.group(1)): json.loads(m.group(2))
             for m in re.finditer(r"^\| step (\d+): (\{.*\})$", out + resumed, re.M)}
    cli_bad = []
    if sorted(steps) != list(range(1, PARA_RESUME + 1)):
        cli_bad.append(f"logged steps {sorted(steps)}")
    for n, lg in steps.items():  # "step n" logs step n - 1: the discriminators from step 1
        spk = {k for k in lg if "_spk" in k}
        if not all(math.isfinite(v) for v in lg.values()) or (n > 1 and len(spk) != 9):
            cli_bad.append(f"step {n}: {lg}")
    if (rs["start_step"], rs["end_step"]) != (PARA_STEPS, PARA_RESUME):
        cli_bad.append(f"resume {rs['start_step']} -> {rs['end_step']}")
    for summ in (s, rs):
        if {k: summ[k] for k in want(0)} != want(summ["vocoder_calls"]):
            cli_bad.append(f"train launches {summ}")
    gen_dir = os.path.join(work, f"generated_{PARA_RESUME}_", "wavs")
    wavs = {k: sorted(glob.glob(os.path.join(gen_dir, f"{k}_wavout", "*.wav")))
            for k in ("gt_a", "gt_p", "a2a", "p2p", "a2p")}
    lengths = {}
    for k, paths in wavs.items():
        lengths[k] = []
        for p in paths:
            with wave.open(p) as f:
                lengths[k].append(f.getnframes())
    silent = [os.path.basename(p) for v in wavs.values() for p in v if wav_rms(p) < 1.0]
    n_test = len(read_split(os.path.join(WORK, "binarize", "binary"), "test"))
    shapes_ok = (all(len(v) == n_test for v in lengths.values())
                 and all(n > 0 and n % 128 == 0 for v in lengths.values() for n in v)
                 and lengths["gt_a"] == lengths["a2a"]
                 and lengths["gt_p"] == lengths["p2p"] == lengths["a2p"])
    launches = {k: isum[k] for k in want(0)}
    if (not shapes_ok or silent or isum["vocoder_calls"] != 5 * n_test
            or launches != want(isum["vocoder_calls"])):
        cli_bad.append(f"--infer: lengths {lengths}, silent {silent}, {isum}")
    ckpt = torch.load(os.path.join(work, f"model_ckpt_steps_{PARA_RESUME}.ckpt"),
                      map_location="cpu", weights_only=True)["state_dict"]
    if "mel_disc_spk" not in ckpt or f"model_ckpt_steps_{PARA_STEPS}.ckpt" not in resumed:
        cli_bad.append("the resume did not carry the speaker discriminator")
    row = dict(ok=not bad and not cli_bad, problems=bad + cli_bad, in_process=rows,
               in_process_s=in_process_s, cli=dict(
                   task=PARA_CLI_TASK, wall_s=wall, resume_in_process_wall_s=wall_resume,
                   infer_in_process_wall_s=wall_infer, summary=s, resume_summary=rs,
                   infer_summary=isum,
                   wav_lengths=lengths, last_step_losses=steps.get(PARA_RESUME)),
               seconds=time.perf_counter() - t0)
    emit("svb_para", **row)
    if not row["ok"]:
        raise AssertionError(f"svb_para: {row['problems']}")
    return {"resblock_conv1d_bf16": launches["resblock_conv1d_bf16_launches"],
            "lrelu_bf16": launches["lrelu_bf16_launches"]}


def phase_svb_para_card_vs_cpu(vc_work, devices=("cpu", "cuda")):
    """One generator + discriminator step of every configuration of
    ``PARA_CONFIGS`` on the CPU and on the card, from the same seeded
    weights (the pretrained tasks' ASR from phase 17), on two train items
    cropped to 192 frames (phones injected for the constraint task), with
    pinned discriminator windows and the same dropout masks (drawn on the
    CPU), TF32 off, in float64 and float32. Gates, float64 only (phase 9's):
    losses within 1e-4 relative, gradients per tensor within 1e-3 of its
    scale; the float32 differences are printed beside them."""
    import numpy as np
    import torch
    from neuralsvb_torch.hparams import hparams_scope
    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    rows, bad = {}, []
    for name, (cls_name, over) in PARA_CONFIGS.items():
        runs = {}
        for dtype in (f32, f64):
            for side, dev in zip(("cpu", "card"), devices):
                task, hp = para_task(cls_name, over, vc_work, dev,
                                     max_frames=PARA_CARD_VS_CPU["frames"])
                with hparams_scope(hp):
                    task.model.to(dtype)
                    for d in task.discriminators.values():
                        d.to(dtype)
                    task.rand_device = torch.device("cpu")
                    task.disc_start_frames_wins = PARA_CARD_VS_CPU["starts"]
                    grads = {}
                    task.grad_hook = lambda group, params, grads=grads: grads.__setitem__(
                        group, [p.grad.detach().cpu().double().clone() for p in params])
                    ds = task.dataset_cls("train", shuffle=False)
                    batch = ds.collater([ds[i] for i in range(PARA_CARD_VS_CPU["items"])])
                    if cls_name == "ParaPPGConstraintTask":
                        batch["txt_tokens"] = np.tile(np.asarray(PARA_TOKENS),
                                                      (batch["nsamples"], 1))
                    torch.set_default_dtype(dtype)
                    try:
                        logs = {}
                        for idx in (0, 1):
                            logs.update({f"{idx}/{k}": float(torch.as_tensor(v).detach())
                                         for k, v in task.training_step(batch, 1, idx)[1].items()})
                    finally:
                        torch.set_default_dtype(f32)
                runs[side, dtype] = logs, grads
                del task
        rel = {dt: loss_rel(runs["card", dt][0], runs["cpu", dt][0]) for dt in (f32, f64)}
        groups = {}
        for group in ("gen", "disc"):
            scales = grad_scales(runs["cpu", f64][1][group])
            groups[group] = {
                "card_vs_cpu_f64": grads_over_scale(runs["card", f64][1][group],
                                                    runs["cpu", f64][1][group], scales),
                "card_vs_cpu_f32": grads_over_scale(runs["card", f32][1][group],
                                                    runs["cpu", f32][1][group], scales)}
        ok = (runs["card", f64][0].keys() == runs["cpu", f64][0].keys()
              and max(rel[f64].values()) <= 1e-4
              and all(g["card_vs_cpu_f64"] <= 1e-3 for g in groups.values()))
        rows[name] = dict(ok=ok, task=cls_name, over=over,
                          max_loss_rel_err_f64=max(rel[f64].values()),
                          max_loss_rel_err_f32=max(rel[f32].values()),
                          grads_over_scale=groups, losses=len(runs["cpu", f64][0]))
        if not ok:
            bad.append(name)
    emit("svb_para_card_vs_cpu", ok=not bad, failed=bad, items=PARA_CARD_VS_CPU["items"],
         frames=PARA_CARD_VS_CPU["frames"], tol_loss=1e-4, tol_grad_f64=1e-3, **rows,
         seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"svb_para card vs CPU: { {n: rows[n] for n in bad} }")


SHARD_INFER = dict(items=3, batch=2)  # batches (2, 1): the last one ragged
DENOISE_C = 0.01


def phase_serving_leftovers(voc, device="cuda:0"):
    """(a) ``shard_infer``: the flagship's ``--infer`` on phase 8's
    checkpoint through ``torchrun --nproc_per_node 2`` (both ranks on
    ``device``, over gloo) at ``mesh_shape: data:2``, ``infer_batch_size:
    2`` and three test items (a ragged last batch, run whole by rank 0),
    at zero noise, beside the same ``--infer`` in this process. Checks: the
    mel trees hold the same files, within 1e-4; the wav trees the same names
    and lengths; each rank launches 18 x stages convs and one pre-pass per
    stage per vocoder call it made, and the ranks' calls sum to this
    process's.

    (b) The denoiser: one vocoder call with ``vocoder_denoise_c`` on the card
    and on the CPU (a 1000-frame mel, phase 4's generator): the card's
    denoised wav against the CPU's at phase 5's bf16 gates, its launches,
    that denoising changed the wav, and the card call's median time with
    and without the denoiser (5 calls). Returns (the ranks' launches, the
    denoised call's launches)."""
    import numpy as np
    import torch
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    from neuralsvb_torch.utils.profiling import median_ms
    t0 = time.perf_counter()
    stages = len(voc["upsample_rates"])
    on_card = device.startswith("cuda")
    work = os.path.join(WORK, "train_work")  # phase 8's checkpoints
    cfg = train_config(os.path.join(WORK, "voc"), device=device, name="shard_infer.yaml",
                       zero_noise=True, infer_batch_size=SHARD_INFER["batch"],
                       num_test_samples=SHARD_INFER["items"], shard_infer=True, ds_workers=0)
    hp = set_hparams(config=cfg, hparams_str=f"work_dir={work},gen_dir_name=one",
                     print_hparams=False, global_hparams=False)
    hp["infer"] = True
    t1 = time.perf_counter()
    with hparams_scope(hp):
        one = SVBVAEMleTask.start()
    one_s = time.perf_counter() - t1
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "neuralsvb_torch.tasks.run", "--config", cfg, "--infer", "--hparams",
           f"work_dir={work},gen_dir_name=two,mesh_shape=data:2"]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    two_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise RuntimeError(f"sharded --infer failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    ranks = {s["rank"]: s for s in (json.loads(m.group(1)) for m in re.finditer(
        r"^\| infer summary: (\{.*\})$", proc.stdout, re.M))}

    def tree(gen, kind, ext):
        root = os.path.join(work, f"generated_{TRAIN_RESUME}_{gen}", kind)
        return {os.path.relpath(p, root): p
                for p in sorted(glob.glob(os.path.join(root, "*", f"*.{ext}")))}
    mels = {g: tree(g, "mels", "npy") for g in ("one", "two")}
    wavs = {g: tree(g, "wavs", "wav") for g in ("one", "two")}
    mel_err = max((float(np.abs(np.load(mels["two"][k]) - np.load(p)).max())
                   for k, p in mels["one"].items() if k in mels["two"]), default=float("inf"))

    def n_frames(p):
        with wave.open(p) as f:
            return f.getnframes()
    same_wavs = (wavs["one"].keys() == wavs["two"].keys()
                 and all(n_frames(p) == n_frames(wavs["two"][k]) for k, p in wavs["one"].items()))
    keys = ("resblock_conv1d_bf16_launches", "lrelu_bf16_launches", "resblock_conv1d_launches")

    def want(calls):
        return dict(zip(keys, (18 * stages * calls * on_card, stages * calls * on_card, 0)))
    rank_launches = {r: {k: s[k] for k in keys} for r, s in ranks.items()}
    shard = dict(
        ranks=sorted(ranks), utts={r: s["utts"] for r, s in ranks.items()},
        vocoder_calls={r: s["vocoder_calls"] for r, s in ranks.items()},
        one_vocoder_calls=one["vocoder_calls"], launches=rank_launches,
        mel_files=len(mels["one"]), mel_max_abs_err=mel_err, same_wav_tree=same_wavs,
        one_process_s=one_s, two_ranks_s=two_s, one_rtf=one["rtf"],
        rank_rtf={r: s["rtf"] for r, s in ranks.items()})
    shard_ok = (sorted(ranks) == [0, 1] and mels["one"].keys() == mels["two"].keys()
                and len(mels["one"]) == 5 * SHARD_INFER["items"] and mel_err <= 1e-4
                and same_wavs and all(s["world"] == 2 for s in ranks.values())
                and sum(s["vocoder_calls"] for s in ranks.values()) == one["vocoder_calls"]
                and all(rank_launches[r] == want(s["vocoder_calls"]) for r, s in ranks.items()))

    # (b) the denoiser
    T = 1000
    t = np.arange(T) * 128 / SR
    f0 = (220.0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))).astype(np.float32)
    mel = (np.random.RandomState(5).randn(T, voc["audio_num_mel_bins"]) - 4).astype(np.float32)
    base = dict(voc, vocoder_ckpt="", seed=7, fft_size=1024, hop_size=128, win_size=1024)
    out, card_ms = {}, {}
    for dev, mm in ((device, None), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        for c in (0.0, DENOISE_C):
            vocoder = HifiGAN(dict(base, device=dev, vocoder_denoise_c=c))
            vocoder.model.mm_dtype = mm
            for k in fr.KERNEL_COUNTERS:
                k.launches = 0
            out[dev, mm, c] = vocoder.spec2wav(mel, f0=f0, zero_noise=True).cpu()
            if dev == device and c > 0:
                den_launches = {k.__name__: k.launches for k in fr.KERNEL_COUNTERS}
            if dev == device and on_card:  # the call's time, with and without the denoiser
                card_ms[c] = median_ms(lambda v=vocoder: v.spec2wav(mel, f0=f0, zero_noise=True),
                                       n=5, warmup=1)
    card, cpu_bf16, cpu_f32 = (out[device, None, DENOISE_C], out["cpu", torch.bfloat16, DENOISE_C],
                               out["cpu", torch.float32, DENOISE_C])
    den = dict(c=DENOISE_C, frames=T, launches=den_launches,
               call_ms=card_ms.get(0.0), denoised_call_ms=card_ms.get(DENOISE_C),
               wav_max_abs_err=float((card - cpu_bf16).abs().max()),
               wav_mean_abs_err=float((card - cpu_bf16).abs().mean()),
               cpu_bf16_f32_gap=float((cpu_bf16 - cpu_f32).abs().mean()),
               denoise_change=float((card - out[device, None, 0.0]).abs().max()))
    den["ratio"] = den["wav_mean_abs_err"] / den["cpu_bf16_f32_gap"]
    den_ok = (den["wav_max_abs_err"] <= 2e-3 and den["ratio"] <= WAV_MEAN_RATIO
              and den["denoise_change"] > 1e-4 and bool(torch.isfinite(card).all())
              and card.shape == (T * 128,)
              and den_launches == {"resblock_conv1d_bf16": 18 * stages * on_card,
                                   "lrelu_bf16": stages * on_card, "resblock_conv1d": 0,
                                   "resblock_cluster_backward_cuda": 0})
    row = dict(ok=shard_ok and den_ok, shard_infer=dict(shard, ok=shard_ok),
               denoise=dict(den, ok=den_ok), seconds=time.perf_counter() - t0)
    emit("serving_leftovers", **row)
    if not row["ok"]:
        raise AssertionError(f"serving leftovers: {row}")
    return rank_launches, den_launches


# phase 35: one 2000-frame utterance's NSF excitation (2000 x 128 samples);
# per segment an odd multiple of sr/1024 Hz (0 = unvoiced): every phase sum
# is exact in float32 on both devices, and no pulse peak falls halfway
# between two samples (two equal neighbours would leave the pulse to rounding)
NSF_SEGMENT_K = (9, 0, 13, 11, 0, 15, 17, 0)
CYC_BETA = 0.87
NSF_TOL = 1e-5
FLOPS_REL_TOL = 0.05  # op_flops of the plain cluster against cluster_work


def nsf_f0(n):
    """[1, n, 1] float32 Hz of ``NSF_SEGMENT_K``, equal segments."""
    import numpy as np
    k = np.repeat(np.array(NSF_SEGMENT_K), -(-n // len(NSF_SEGMENT_K)))[:n]
    return (k * SR / 1024).astype(np.float32)[None, :, None]


def phase_last_modules(voc, spec, bucket_rows, device="cuda"):
    """35. The last JAX modules on the card.

    Profiling (``neuralsvb_torch/utils/profiling.py``): one warm vocoder call
    (seeded full-width HiFiGAN-NSF, a 2000-frame mel: the 2048 bucket, the
    bf16 ResBlock kernel) under ``profiler_trace``: the kernels' merged busy
    time (``device_busy``) beside their summed time (``kernel_split``), the
    top 10 kernels, 54 + 3 launches (counts zeroed just before the call, the
    profile's cluster kernels the same number), the same call between two
    CUDA events; ``op_flops`` of the plain cluster at the bucket's three
    stage shapes within 5% of ``cluster_work``; ``roofline`` of the cluster
    equal to phase 3's bound. NSF sources: ``PulseGen`` and
    ``SourceModuleCycNoise`` on a 2000-frame F0 track (voiced and unvoiced
    segments) on the card against the CPU with the same injected draws, in
    float32, every output within 1e-5. Figures: whether ``matplotlib`` is
    installed, and the logger's and phase 8's validation's figures agree with
    it. mp3: whether ``ffmpeg`` is installed; without it the port's
    ``load_wav`` raises the JAX package's ``need ffmpeg`` error, with it one
    synthetic sung wav round-trips through mp3."""
    import contextlib
    import importlib.util
    import io
    import numpy as np
    import torch
    from neuralsvb_torch.models import nsf
    from neuralsvb_torch.ops import fused_resblock as fr
    from neuralsvb_torch.ops.audio import load_wav, save_wav
    from neuralsvb_torch.training.logger import JsonLogger
    from neuralsvb_torch.utils import profiling as P
    from neuralsvb_torch.vocoders.hifigan import HifiGAN
    bad = []
    on_card = device == "cuda"  # CPU tensors take the plain cluster

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # profiling: the main path's vocoder call
    T = 2000
    t = np.arange(T) * 128 / SR
    f0 = (220.0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))).astype(np.float32)
    mel = (np.random.RandomState(35).randn(T, voc["audio_num_mel_bins"]) - 4).astype(np.float32)
    vocoder = HifiGAN(dict(voc, vocoder_ckpt="", device=device, seed=7, vocoder_denoise_c=0.0))

    def call():
        return vocoder.spec2wav(mel, f0=f0, zero_noise=True)
    call()
    sync()
    for c in fr.KERNEL_COUNTERS:
        c.launches = 0
    with P.profiler_trace(os.path.join(WORK, "traces")) as prof:
        wav = call()
        sync()
    launches = {c.__name__: c.launches for c in fr.KERNEL_COUNTERS}
    kinds, ops = P.kernel_split(prof)
    summed_ms = sum(v[0] for v in kinds.values())
    merged_ms = {k: v * 1e3 for k, v in P.device_busy(prof).items()}
    stages = len(voc["upsample_rates"])
    want = {"resblock_conv1d_bf16": 18 * stages * on_card, "lrelu_bf16": stages * on_card,
            "resblock_conv1d": 0, "resblock_cluster_backward_cuda": 0}
    profiled_cluster = kinds.get("ResBlock cluster kernels", [0.0, 0])[1]
    if launches != want or profiled_cluster != 19 * stages * on_card:
        bad.append(f"launches {launches} != {want}, profiled cluster kernels {profiled_cluster}")
    busy_keys = [f"cuda:{torch.cuda.current_device()}"] if on_card else ["cpu"]
    if list(merged_ms) != busy_keys:
        bad.append(f"device_busy keys {list(merged_ms)} != {busy_keys}")
    if not bool(torch.isfinite(wav).all()):
        bad.append("vocoder wav not finite")
    event_ms = P.device_ms(call, n=1) if on_card else None
    profiling = dict(
        frames=T, bucket=2048, wall_launches=launches, profiled_cluster_kernels=profiled_cluster,
        kernel_ms=summed_ms, device_ops=ops, merged_busy_ms=merged_ms,
        merged_over_summed=sum(merged_ms.values()) / summed_ms if summed_ms else None,
        by_kind_ms={k: {"ms": v[0], "launches": v[1]} for k, v in kinds.items()},
        top_ops=[{"name": n[:100], "ms": sec * 1e3, "launches": k}
                 for n, sec, k in P.top_ops(prof, k=10)],
        cuda_event_ms=event_ms)

    # op_flops of the plain cluster, and its roofline, at the bucket's shapes
    gen = torch.Generator().manual_seed(35)
    counted = work = bound_ms = 0.0
    for (B, C, Tn), r in zip(BUCKET_SHAPES, bucket_rows):
        x = torch.randn(B, C, Tn, generator=gen).to(device)
        w = random_cluster(C, spec, gen, device)
        with torch.no_grad():
            counted += P.op_flops(fr.resblock_cluster_plain, x, w, spec)
        flop, nbytes = cluster_work(B, C, Tn, spec, 2)
        work += flop
        bound = P.roofline(flop, nbytes, r["kernel_ms"] / 1e3, torch.bfloat16)[0]
        bound_ms += bound * 1e3 if on_card else 0.0  # no peak rates for the CPU
        del x, w
    phase3_bound_ms = sum(r["bound_ms"] for r in bucket_rows)
    flops = dict(op_flops=counted, cluster_work=work, rel=abs(counted - work) / work,
                 tol=FLOPS_REL_TOL, roofline_bound_ms=bound_ms, phase3_bound_ms=phase3_bound_ms,
                 peak_bf16_flops=P.peak_flops_for_device(torch.bfloat16),
                 peak_hbm_bytes=P.peak_hbm_bytes_for_device())
    if flops["rel"] > FLOPS_REL_TOL or abs(bound_ms - phase3_bound_ms) > 1e-9 * phase3_bound_ms:
        bad.append(f"cluster FLOPs / bound: {flops}")

    # the pulse and cyclic-noise sources, card vs CPU, same draws
    L = T * 128
    f0s = torch.as_tensor(nsf_f0(L))
    voiced = f0s[f0s > 0]
    g = torch.Generator().manual_seed(36)
    draws = dict(rand_ini=torch.rand(1, 1, generator=g),
                 sine_noise=torch.randn(1, L, 1, generator=g),
                 pulse_noise=torch.randn(1, L, 1, generator=g),
                 burst=torch.randn(int(4.6 * SR / float(voiced.mean())), 1, generator=g),
                 noise=torch.randn(1, L, 1, generator=g))
    pulse_keys = ("rand_ini", "sine_noise", "pulse_noise")
    sources = {}
    for name, module, args, keys in (
            ("PulseGen", nsf.PulseGen(SR), (), pulse_keys),
            ("SourceModuleCycNoise", nsf.SourceModuleCycNoise(SR), (CYC_BETA,), draws)):
        outs = {}
        for dev in ("cpu", device):
            with torch.no_grad():
                outs[dev] = module.to(dev)(f0s.to(dev), *args,
                                           **{k: draws[k].to(dev) for k in keys})
        errs = [float((a.cpu() - b).abs().max()) for a, b in zip(outs[device], outs["cpu"])]
        sources[name] = dict(max_abs_err=max(errs), per_output=errs, tol=NSF_TOL,
                             finite=all(bool(torch.isfinite(o).all()) for o in outs[device]))
        if max(errs) > NSF_TOL or not sources[name]["finite"]:
            bad.append(f"{name} card vs CPU: {sources[name]}")
    cyc = outs[device][0]
    sources.update(samples=L, voiced_share=float((f0s > 0).float().mean()),
                   burst_taps=int(draws["burst"].shape[0]),
                   cyc_noise_rms=float(cyc.pow(2).mean().sqrt()))

    # figures: the logger's probe and phase 8's validation
    mpl = importlib.util.find_spec("matplotlib") is not None
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        logger = JsonLogger(os.path.join(WORK, "figures_probe"))
    no_mpl_line = "| figures not written: no matplotlib" in printed.getvalue()
    pngs = glob.glob(os.path.join(WORK, "train_work", "lightning_logs", "version_*",
                                  "figures", "*.png"))
    figures = dict(matplotlib=mpl, logger_writes_figures=logger.writes_figures,
                   no_matplotlib_line=no_mpl_line, phase8_validation_pngs=len(pngs))
    if logger.writes_figures != mpl or no_mpl_line == mpl or (len(pngs) > 0) != mpl:
        bad.append(f"figures: {figures}")

    # mp3 input
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        try:
            load_wav(os.path.join(WORK, "probe.mp3"), SR)
            error = None
        except RuntimeError as exc:
            error = str(exc)
        mp3 = {"ffmpeg": None, "load_wav_error": error}
        if not (error or "").startswith("need ffmpeg to decode .mp3 files"):
            bad.append(f"mp3 without ffmpeg: {mp3}")
    else:
        src = os.path.join(WORK, "mp3_probe.wav")
        tone = 0.3 * np.sin(2 * np.pi * 220 * np.arange(int(6.0 * SR)) / SR)
        save_wav(tone.astype(np.float32), src, SR)
        subprocess.run([ffmpeg, "-v", "error", "-y", "-i", src, src[:-4] + ".mp3"],
                       check=True, timeout=120)
        back, sr = load_wav(src[:-4] + ".mp3", SR)
        mp3 = {"ffmpeg": ffmpeg, "wav_samples": len(tone), "mp3_samples": len(back),
               "sr": sr, "frames_wav": len(tone) // 128, "frames_mp3": len(back) // 128}
        if sr != SR or abs(len(back) - len(tone)) > 2 * 1152 or not np.isfinite(back).all():
            bad.append(f"mp3 round trip: {mp3}")
    emit("last_modules", ok=not bad, problems=bad, profiling=profiling, flops=flops,
         nsf_sources=sources, figures=figures, mp3=mp3)
    if bad:
        raise AssertionError(f"last modules: {bad}")
    return launches


def build_all(libs=None):
    """nvcc for each CUDA source and g++ for the host library (or the
    libraries ``libs`` names), all started together."""
    from neuralsvb_torch import native
    from neuralsvb_torch.ops import (amp_activation, chi2, dilated_conv, fused_resblock as fr,
                                     mrd_conv)
    libs = libs or {"resblock_bf16": fr.LIBRARY_BF16, "fused_resblock": fr.LIBRARY,
                    "dilated_conv_backward": dilated_conv.LIBRARY, "chi2_dist": chi2.LIBRARY,
                    "amp_activation": amp_activation.LIBRARY,
                    "mrd_conv_backward": mrd_conv.LIBRARY, "native_dtw": native.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.get) for lib in libs.values()]:
            fut.result()
    emit("build", seconds=time.perf_counter() - t0, libraries={
        name: dict(source=os.path.relpath(str(lib.source), REPO),
                   library=os.path.relpath(str(lib.path), REPO),
                   seconds=lib.build_seconds, flags=lib.flags,
                   ptxas=[ln.strip() for ln in lib.build_log.splitlines()
                          if "registers" in ln or "spill" in ln])
        for name, lib in libs.items()})


def main():
    if not os.path.isdir(os.path.join(REPO, "neuralsvb_torch")):
        raise SystemExit("chip_smoke.py runs from a checkout of the repository "
                         "(neuralsvb_torch/ not found beside it)")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run "
                           "needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=name, device_count=torch.cuda.device_count(),
         nvidia_smi=smi)
    tf32(False)

    from neuralsvb_torch.ops import amp_activation, amp_conv, chi2, fused_resblock as fr, mrd_conv
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    build_all()

    spec = fr.make_spec((3, 7, 11), ((1, 3, 5),) * 3)
    rows16, rows32, worst16, worst32 = phase_kernel(fr, spec)
    bwd_rows = phase_cluster_backward(fr, spec)
    amp_rows = phase_amp(amp_activation)
    conv_rows = phase_amp_conv_backward(amp_conv)
    mrd_rows = phase_mrd_conv_backward(mrd_conv)
    chi2_rows, chi2_worst = phase_chi2(chi2)
    voc = vocoder_keys()
    # the --infer process zeroes its counts at test_start and reports them at
    # test_end: the counts cover the main path's test loop only
    launches = phase_main_path(voc)
    # BigVGAN's training process zeroes its counts when fit starts and
    # reports them in its summary
    bigvgan_launches = phase_bigvgan_train()
    # the f32 kernel's path: the card's f32 vocoder run, counts zeroed before
    f32_launches = phase_card_vs_cpu(voc)
    # each binarize process starts its count at 0 and reports it in its
    # summary: the count covers the binarize main path only
    cfgs, chi2_launches = phase_binarize()
    phase_binarize_card_vs_cpu(cfgs)
    # the training process zeroes its counts when fit starts and reports them
    # in its summary: the counts cover the training path (its validation)
    train_launches = phase_train(voc)
    _, runs9, cpu64_deltas, cpu64_state = phase_train_card_vs_cpu()
    # the vocoder's training process zeroes its counts when fit starts and
    # reports them in its summary: the counts cover that training path
    voc_launches, voc_chi2_launches, voc_cfg = phase_vocoder_train()
    n = len(STAGE_SHAPES)
    bucket, stage32 = rows16[n:2 * n], rows32[:n]  # the main path's shapes; T_mel 1024
    train_rows = rows16[-len(TRAIN_SHAPES):]  # the vocoder training path's
    phase_vocoder_step_time(voc_cfg, train_rows, spec)
    phase_vocoder_card_vs_cpu(voc_cfg)
    # each training and --infer process of the technique-prior recipes zeroes
    # its counts when it starts its loop and reports them in its summary
    var_train_launches, var_infer_launches = phase_variants_train(voc)
    phase_variants_card_vs_cpu()
    # PWG runs none of the repo's kernels; its summaries' counts are checked at 0
    pwg_cfg = phase_pwg_train()
    phase_pwg_step_time()
    phase_pwg_card_vs_cpu(pwg_cfg)
    # the counts are zeroed just before the JAX-format vocoder's call
    jax_ckpt_launches = phase_jax_checkpoint(voc)
    # ASR pre-training runs none of the repo's kernels (its summaries' counts
    # are checked at 0); the flagship warm-started from its checkpoint zeroes
    # its counts when fit starts and reports them in its summary
    vc_cfg = phase_vcppg_binarize()
    vc_work = phase_vcppg_train(vc_cfg)
    phase_vcppg_step_time()
    phase_vcppg_card_vs_cpu(vc_cfg)
    warm_launches = phase_vcppg_warm_start(voc, vc_work)
    # the flagship's training options: bf16 (step time, card vs the CPU's
    # float64 step of phase 9), accumulation, the bf16 vocoder (counts
    # zeroed just before its call), two ranks on the card with the other
    # options on (rank 0's training process zeroes its counts when fit
    # starts and reports its validation's)
    phase_bf16_step_time()
    phase_bf16_card_vs_cpu(runs9, cpu64_deltas, cpu64_state)
    del runs9, cpu64_deltas, cpu64_state
    phase_accum_card_vs_cpu()
    bf16_voc_launches = phase_bf16_vocoder(voc)
    dp_launches = phase_data_parallel(voc)
    # the FS2 family: its training processes run no kernel of the repo (their
    # summaries' counts are checked at 0); the HiFiGAN --infer process zeroes
    # its counts at test_start and reports them at test_end
    fs2_cfg = phase_fs2_binarize()
    fs2_launches = phase_fs2_train(fs2_cfg, voc, os.path.join(WORK, "pwg_work"))
    phase_fs2_step_time()
    phase_fs2_card_vs_cpu(fs2_cfg)
    # the harnesses: each pitch-alignment process reports the χ² launches
    # of each aligner's pass in its summary
    harness_launches = phase_pitch_alignment(cfgs)
    phase_mcd()
    # the SVBPara family: the CLI's training and --infer processes zero their
    # counts when their loops start and report them in their summaries
    para_launches = phase_svb_para(voc, vc_work)
    phase_svb_para_card_vs_cpu(vc_work)
    # shard_infer: each rank's --infer process zeroes its counts at
    # test_start and reports them at test_end; the denoised vocoder call's
    # counts are zeroed just before it
    shard_launches, denoise_launches = phase_serving_leftovers(voc)
    # the last modules: the profiled vocoder call's counts are zeroed just
    # before it
    profiled_launches = phase_last_modules(voc, spec, bucket)

    def total(rows, key):
        return sum(r[key] for r in rows)

    chi2_row = chi2_rows[0]  # 2400 x 2400
    bwd_train = bwd_rows[:len(TRAIN_SHAPES)]
    print(json.dumps({"kernels": [{
        "name": "resblock_conv1d_bf16", "route": "cuda",
        "source": "neuralsvb_torch/csrc/resblock_bf16.cu", "replaces": TPU_KERNEL,
        "launches": launches["resblock_conv1d_bf16"],
        "prepass_launches": launches["lrelu_bf16"],
        "train_launches": train_launches["resblock_conv1d_bf16_launches"],
        "train_prepass_launches": train_launches["lrelu_bf16_launches"],
        "vocoder_train_launches": voc_launches["resblock_conv1d_bf16_launches"],
        "vocoder_train_prepass_launches": voc_launches["lrelu_bf16_launches"],
        "variants_train_launches": var_train_launches["resblock_conv1d_bf16_launches"],
        "variants_train_prepass_launches": var_train_launches["lrelu_bf16_launches"],
        "variants_infer_launches": var_infer_launches["resblock_conv1d_bf16_launches"],
        "variants_infer_prepass_launches": var_infer_launches["lrelu_bf16_launches"],
        "jax_checkpoint_launches": jax_ckpt_launches["resblock_conv1d_bf16"],
        "jax_checkpoint_prepass_launches": jax_ckpt_launches["lrelu_bf16"],
        "vcppg_warm_start_launches": warm_launches["resblock_conv1d_bf16_launches"],
        "vcppg_warm_start_prepass_launches": warm_launches["lrelu_bf16_launches"],
        "bf16_vocoder_launches": bf16_voc_launches["resblock_conv1d_bf16"],
        "bf16_vocoder_prepass_launches": bf16_voc_launches["lrelu_bf16"],
        "data_parallel_train_launches": dp_launches["resblock_conv1d_bf16_launches"],
        "data_parallel_train_prepass_launches": dp_launches["lrelu_bf16_launches"],
        "fs2_infer_launches": fs2_launches["resblock_conv1d_bf16"],
        "fs2_infer_prepass_launches": fs2_launches["lrelu_bf16"],
        "svb_para_infer_launches": para_launches["resblock_conv1d_bf16"],
        "svb_para_infer_prepass_launches": para_launches["lrelu_bf16"],
        "shard_infer_launches": {r: v["resblock_conv1d_bf16_launches"]
                                 for r, v in shard_launches.items()},
        "shard_infer_prepass_launches": {r: v["lrelu_bf16_launches"]
                                         for r, v in shard_launches.items()},
        "denoise_launches": denoise_launches["resblock_conv1d_bf16"],
        "denoise_prepass_launches": denoise_launches["lrelu_bf16"],
        "profiled_call_launches": profiled_launches["resblock_conv1d_bf16"],
        "profiled_call_prepass_launches": profiled_launches["lrelu_bf16"],
        "vocoder_train_shapes_ms": total(train_rows, "kernel_ms"),
        "vocoder_train_shapes_plain_ms": total(train_rows, "plain_ms"),
        "vocoder_train_shapes_bound_ms": total(train_rows, "bound_ms"),
        "max_abs_err": worst16,
        "ms": total(bucket, "kernel_ms"), "plain_ms": total(bucket, "plain_ms"),
        "bound_ms": total(bucket, "bound_ms"), "bound_by": bucket[0]["bound_by"],
        "library_ms": None, "plain_tf32_ms": total(bucket, "plain_tf32_ms"),
        "cudnn_bf16_ms": total(bucket, "cudnn_bf16_ms")}, {
        "name": "resblock_conv1d", "route": "cuda",
        "source": "neuralsvb_torch/csrc/fused_resblock.cu",
        "replaces": TPU_KERNEL, "launches": f32_launches, "max_abs_err": worst32,
        "ms": total(stage32, "kernel_ms"), "plain_ms": total(stage32, "plain_ms"),
        "bound_ms": total(stage32, "bound_ms"), "bound_by": stage32[0]["bound_by"],
        "library_ms": None}, {
        "name": "cluster_bwd", "route": "cuda",
        "source": "neuralsvb_torch/csrc/dilated_conv_backward.cu", "replaces": None,
        "launches_per_stage": bwd_rows[0]["launches"],
        "vocoder_train_step_launches": total(bwd_train, "launches"),
        "ms": total(bwd_train, "kernel_ms"), "plain_ms": total(bwd_train, "plain_ms"),
        "twin_ms": total(bwd_train, "twin_ms"), "bound_ms": total(bwd_train, "bound_ms"),
        "bound_by": "operations", "library_ms": None}, {
        "name": "amp_activation", "route": "cuda",
        "source": "neuralsvb_torch/csrc/amp_activation.cu", "replaces": None,
        "bigvgan_train_launches": bigvgan_launches,
        "fwd_ms": total(amp_rows, "fwd_ms"), "bwd_ms": total(amp_rows, "bwd_ms"),
        "plain_fwd_bwd_ms": total(amp_rows, "plain_fwd_bwd_ms"),
        "bound_ms": total(amp_rows, "fwd_bound_ms") + total(amp_rows, "bwd_bound_ms"),
        "bound_by": amp_rows[0]["bound_by"], "library_ms": None}, {
        "name": "amp_conv_backward", "route": "cuda",
        "source": "neuralsvb_torch/csrc/dilated_conv_backward.cu", "replaces": None,
        "bigvgan_train_launches": bigvgan_launches["amp_conv_backward_cuda_launches"],
        "ms": sum(r["per_step"] * r["kernel_ms"] for r in conv_rows),
        "plain_ms": sum(r["per_step"] * r["plain_ms"] for r in conv_rows),
        "bound_ms": sum(r["per_step"] * r["bound_ms"] for r in conv_rows),
        "bound_by": "operations", "library_ms": None}, {
        "name": "mrd_conv_backward", "route": "cuda",
        "source": "neuralsvb_torch/csrc/mrd_conv_backward.cu", "replaces": None,
        "bigvgan_train_launches": bigvgan_launches["mrd_conv_backward_cuda_launches"],
        "ms": total(mrd_rows, "kernel_ms"), "plain_ms": total(mrd_rows, "cudnn_ms"),
        "bound_ms": total(mrd_rows, "bound_ms"), "bound_by": "operations",
        "library_ms": None}, {
        "name": "chi2_dist", "route": "cuda",
        "source": "neuralsvb_torch/csrc/chi2_dist.cu",
        "replaces": CHI2_TPU_KERNEL, "launches": chi2_launches,
        "vocoder_bin_launches": voc_chi2_launches, "harness_launches": harness_launches,
        "max_abs_err": chi2_worst, "ms": chi2_row["kernel_ms"],
        "device_ms": chi2_row["device_ms"], "plain_ms": chi2_row["plain_ms"],
        "bound_ms": chi2_row["bound_us"] / 1e3, "bound_by": chi2_row["bound_by"],
        "bound_share": chi2_row["bound_share"],
        "issue_bound_ms": chi2_row["issue_bound_us"] / 1e3,
        "issue_share": chi2_row["issue_share"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bf16-map-spread"]:
        bf16_map_spread(sys.argv[2:])
    elif sys.argv[1:2] == ["--binarize-ab"]:
        binarize_ab(sys.argv[2:])
    elif sys.argv[1:2] == ["--cluster-backward"]:
        cluster_backward_main()
    elif sys.argv[1:2] == ["--amp"]:
        amp_main()
    elif sys.argv[1:2] == ["--amp-conv-bwd"]:
        amp_conv_backward_main()
    elif sys.argv[1:2] == ["--mrd-conv-bwd"]:
        mrd_conv_backward_main()
    else:
        main()
