#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dpst_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one H100

Phases (each prints one JSON line; any failure exits non-zero and prints
no result):
  1. device   -- the card's name, and its name and power limit from
                 nvidia-smi;
  2. build    -- compiles the CUDA kernels from dpst_tpu_torch/csrc (nvcc,
                 sm_90a) and reports the seconds, and the registers, local
                 memory, shared memory and blocks per SM of the bf16 Gram
                 and conv bodies (gram_wgmma.cuh, conv3x3_wgmma.cuh; the
                 bias+ReLU forward, the weighted-after backward and block12's
                 Gram cotangent among them);
  3. kernels  -- lap_matvec at 64² (fp32, stats made on the card) against
                 the fp64 CSR matting Laplacian (ops/matting_oracle.py, an
                 oracle independent of the plain version; ORACLE_TOL);
                 gram_fwd's cap on a split's length (gram_stream.
                 FWD_SPLIT_MAX) at the 4096² taps (random operands, K = 4)
                 and gram_relu_fwd's at (64, 2^24), beside the same kernel
                 launched uncapped and at a cap of CAP_ALT: each plan's
                 Grams (and fp32 cuBLAS's) against fp64, the capped ones
                 held to GRAM_FP64_TOL and below the uncapped control's
                 error where the cap binds, device times in turns; then
                 each kernel against its plain PyTorch version on the card,
                 at the shapes of the 512² config3 main path (K = 4 masks,
                 and for gram_fwd, gram_bwd and the fused pair at conv1_1
                 also K = 8, the automatic paths' masks;
                 lap_matvec also at 1024² and 4096², its division by 9
                 against __fdiv_rn on all 2^32 floats, and with pool_bwd
                 timed by device time), for the fused bias+ReLU Gram pair
                 of conv1_1 at the 1024² stage of config4 (gram_relu_bwd
                 also at 512² and 4096², by device time in turns with its
                 yardstick and beside "cook, then gram_wbwd, then relu′"), and for conv3x3 (forward and input
                 gradient, bf16 and fp32) and gram_wbwd (soft masks) at the
                 shapes of the 512² pallas route, with the stated
                 tolerance, the kernel's time, the plain version's time,
                 the computed bound and, where one PyTorch call computes
                 the same function (cuDNN for the conv; or, labelled, a
                 yardstick call), that call's time; gram_fwd and gram_bwd
                 (also at config4's 1024² taps) timed by device time in
                 turns with torch.matmul, the bf16 conv3x3 (on weights
                 packed once, as the path calls it) in turns with cuDNN,
                 the bf16 gram_relu_fwd (also at the pallas route's conv1_1,
                 beside "cook with torch, then gram_fwd" on the same
                 operands) and gram_wbwd (also at config6's conv3_1 and the
                 4096² stream taps) in turns with their yardsticks; then
                 each kernel at shapes that do not fill its tiles; then
                 the bias+ReLU pair (bias_relu_fwd, bias_relu_bwd) bit for
                 bit against the ATen composite at the 13 conv shapes of a
                 2048² step, the batch's and ragged or misaligned ones
                 (bf16, fp32; signed zeros, exact zeros of z + b, ±inf,
                 NaN), timed against its byte bound, and its launches in
                 one 2048² step (13 each way); then the
                 five kernels with a batch grid dimension (lap_matvec,
                 gram_fwd, gram_bwd, gram_relu_fwd, gram_relu_bwd) and
                 pool_bwd on folded channels at the batch path's shapes
                 (B = 8 distinct pairs at 512², K = 4 masks drawn per
                 pair; lap_matvec also with one pair's stats shared by
                 four, as the Γ sweep runs it), each pair against the
                 plain version and bit for bit against its one-pair
                 launch, timed in turns with B one-pair launches of the
                 same kernel, and at shapes where the plans split; then
                 gram_wbwd (conv1_1 … conv5_1) and conv3x3 (the 24
                 convs of a step) with their batch grid
                 dimension at the pallas-route batch's shapes, the same
                 way, in bf16 and fp32, and at B = 2-3 at ragged C, K =
                 1-9, a conv plan with Cin splits; then the block12 entry
                 points on batches (B = 2 at 4096², B = 2 and 3 at 320 ×
                 4096, whose groups of bands run from one pair into the
                 next; bf16 and fp32): each pair bit for bit against its
                 one-pair launch, "B=2" and "B=3" rows timed in turns
                 with the one-pair launches, with the plain version's
                 time, B pairs' bound and cuDNN's yardstick on a batch;
  4. stylize  -- the first main path through the public entry points:
                 `prepare_constants` (timed alone), then `stylize` with
                 PRESETS["config3"] on a seeded 512² pair and four band
                 masks; launch counters are reset just before and read just
                 after; checks the losses, the output, the counters and a
                 bit-identical rerun; profiles ten steps (device time per
                 step by kernel group, device busy share); then a 64² fp32
                 run on the card against the same run on the CPU (the
                 kernels' plain path);
  5. multiscale -- the second main path: `stylize` with PRESETS["config4"]
                 (256² → 512² → 1024², 100 Adam steps per stage) on a
                 seeded 1024² pair and four band masks, counters reset just
                 before and read just after; checks the losses per stage,
                 the output and that the counters equal what the schedule
                 implies (the fused Gram pair at the 1024² stage only);
                 precompute seconds and loop it/s per stage, peak memory;
                 profiles ten steps of the 1024² stage; a short config4
                 run twice (bit-identical); a 64² fp32 config4-shaped run
                 on the fused route, card against CPU;
  6. pallas route -- the third main path: `stylize` with PRESETS["config3"]
                 and conv_impl="pallas", gram_impl="pallas" at 512² (100
                 Adam steps, four band masks), counters reset just before
                 and read just after and held to what the route implies;
                 losses, output, a bit-identical rerun, a profile of ten
                 steps, and a 64² fp32 run of the route, card against CPU;
  7. stream12 -- the fourth main path: `stylize` with PRESETS["config3"]
                 and stream12_impl="pallas" at 4096² (config6 of bench.py:
                 blocks 1-2 streamed in bands through the four block12
                 entry points, whose kernels phase checks them at 256 x
                 4096, K = 4, at edge shapes (W = 260 among them) and with
                 tied maxima, times them at 4096², holds their scratch
                 layout to the one the CPU tests check, and checks and
                 times the backwards' bf16 Gram cotangent stage alone at
                 the 4096² step's group shapes, in turns with a
                 torch.matmul yardstick), 10 Adam steps, four band masks;
                 counters held to what the route implies; precompute
                 seconds, loop it/s and the loop's peak memory; a profile;
                 the standard path (stream12=0) at 4096² for 3 steps with
                 its device time and loop peak, which must be above the
                 route's; a bit-identical rerun at 1024² (stream12=8); a
                 256² fp32 run of the route, card against CPU, and a
                 batch of two there, each pair against its one-pair run;
                 then `stylize_batch` of two distinct 4096² pairs on the
                 route (5 Adam steps): each block12 entry point launched
                 once a step for the batch (counters equal to one pair's
                 run), the loss falls for each pair, output in [0, 255],
                 a bit-identical rerun, each pair against its one-pair
                 `stylize` run (the batch tolerances), ms a step,
                 pair-it/s, loop peak memory, device ms a step by group
                 and busy share beside the one-pair route's;
  8. lbfgs    -- the fifth path: `stylize` with PRESETS["config3"] and
                 optimizer="lbfgs", post_smooth=2, post_smooth_eps=1e-4 at
                 512² (100 L-BFGS steps, callback at 50, four band masks):
                 steps/s and evaluations/s past the callback, the
                 evaluations E and their counts per step, capped and safe
                 steps, precompute seconds, the post-smoothing's device
                 time, peak memory; counters reset just before and read
                 just after, equal to what E implies; the loss falls, the
                 output is finite in [0, 255]; a 10-step rerun gives the
                 first rows bit for bit, and its image again with
                 history_terms="full"; 10 checkpointed steps resumed to 20
                 equal the straight run bit for bit; smooth_local_affine on
                 the card against the CPU; a profile of ten steps; a 64²
                 fp32 run, card against CPU, within the L-BFGS golden's
                 bounds;
  9. segmentation -- PSPNet-50 at full width (46.7 M conv weights, seeded)
                 at its 473² eval size: fp32 logits on the card against the
                 CPU's, labels by the near-tie rule (a label may differ only
                 where the CPU's top-2 margin is below twice the largest
                 logit difference), the bf16 forward finite with labels in
                 [0, 150), `segment_batch` of eight 512² images against
                 eight `segment` calls (near-tie rule) and against a rerun
                 (bit for bit); the bf16 forward's device time, images/s,
                 the sliding protocol on 512 × 768, `merge_classes` on the
                 host, peak memory;
  10. automatic -- the sixth path: `stylize(content, style,
                 PRESETS["config3"])` with no masks at 512² (PSPNet on both
                 images, the class merge, K = 8 padded masks, 100 Adam
                 steps), counters reset just before and read just after and
                 held to what the path implies; losses, output, Σ_k m_k = 1,
                 at most 8 classes, bit-identical reruns of the masks and of
                 10 steps; then at 64² in fp32 the card's labels against the
                 CPU's (near-tie rule) and the CPU's automatic run against
                 the card's given the CPU's masks (1e-3);
  11. autotune -- the seventh path: `autotune(content, style,
                 PRESETS["config3"], rounds=2)`, four Γ run as one batch a
                 round, 50 steps a candidate, automatic masks, 512²;
                 counters held to the rounds' steps (its resolved config
                 takes the fused Gram pair at conv1_1), scores finite in
                 [1, 10], the best Γ the best-scored, the best image the
                 batch's image for that Γ and within the batch tolerance
                 of `stylize` at that Γ under the sweep's resolved config,
                 fp32 NIMA card against CPU (1e-4); an fp32 64² sweep
                 against `stylize` within the JAX package's batch bounds;
                 seconds a call and a sweep, NIMA's device time at B = 4;
  12. batch   -- the eighth path: `stylize_batch` of 8 distinct seeded
                 512² pairs under PRESETS["config3"], K = 4 distinct band
                 masks a pair, 100 steps of 500; counters reset just
                 before and read just after, equal to one pair's; pair-it/s,
                 precompute seconds, device ms per step by kernel group,
                 busy share, peak memory; each pair against its run alone
                 (bf16 tolerances), a bit-identical rerun, the VGG taps of
                 a batch against one image; a 64² fp32 batch of two, card
                 against CPU (1e-3); the same 8 pairs on the pallas route
                 (20 steps: conv3x3 and gram_wbwd batched, counters equal
                 to one pair's, each pair against its run alone,
                 pair-it/s, busy share); and with optimizer="lbfgs" (10
                 steps, the batched L-BFGS: counters equal to one pair's
                 an evaluation × E, each pair against its one-pair run in
                 bf16 and in fp32 (the L-BFGS golden's bounds, the first
                 ten rows within 1e-2 in both), a rerun
                 bit for bit, evaluations/s, busy share of an evaluation,
                 one sync an evaluation for all pairs);
  13. spatial -- the ninth path, on meshes of repeated cuda:0 (virtual:
                 one card stands for several devices; no cross-card time or
                 memory is taken): `matvec_spmd` over 4 row shards against
                 the one-device `lap_matvec` at 512² and 4096² (bit-equal
                 expected, 1e-5; 4 launches a call; event time in turns),
                 and its "local rows" and "ambient mesh" errors;
                 `stylize_spatial` with PRESETS["config3"] and
                 laplacian_impl="pallas" (→ "spmd") at 4096² on 4 row
                 shards, 10 Adam steps, four band masks: the level plan,
                 counters reset just before and read just after and equal
                 to 4 × one device's a step as the plan implies, loop it/s,
                 precompute seconds, peak memory, device ms a step by group
                 with the halo copies apart, the first row against one
                 unsharded step (BATCH_ROW0_TOL), the Grams of every style
                 tap whole and over 4 shards against fp64 (1e-4 of max|G|);
                 at 512² bf16 10 steps sharded against
                 unsharded and a bit-identical rerun; a 64² fp32 sharded
                 run, card against CPU; `stylize_batch` of the batch phase's
                 8 pairs over a mesh of 2, each pair against the batch
                 phase's run (batch tolerances), counters, pair-it/s; a
                 2 × 2 mesh batch and `autotune` over a mesh of 2 at 64²
                 fp32, card against CPU;
  14. cli     -- the CLI, `python3 -m dpst_tpu_torch` in subprocesses on
                 the card at 512² (100 steps a run): PRESETS["config3"] with
                 the four band masks as .npy, a loss CSV and intermediates
                 at 50 and 100, its CSV and PNG bit-equal to an in-process
                 `stylize` of the same files, masks and config; config3
                 without masks (PSPNet, K = 8); --content-dir of 8 images
                 without segmentation (one batch); --autotune over four Γ,
                 one round of 50 steps; L-BFGS with --post-smooth 2 and
                 --metrics; --spatial over the CUDA devices; --device 99
                 and --laplacian-impl spmd without --spatial refused with
                 their messages; each run's wall seconds beside the card's
                 name and power limit;
  15. the {"kernels": [...]} summary (the K = 4 rows, then the Gram rows at
      K = 8 as "<kernel> K=8", then the batched rows as "<kernel> B=8",
      then the block12 entry points on config6's batch as "<entry point>
      B=2", then "lap_matvec spmd": 4 shards at 4096², the loop's form)
      and the nvidia-smi line;
  16. the last line: {"ok": true, "device": {...}}.
It imports nothing of JAX and nothing of the JAX package. Its kernel
groups, roofline bounds and seeded images and masks are the benchmark's
(`port_bench.trace`, `port_bench.work`, `port_bench.inputs`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.inputs import band_masks, smooth_image, textured_image
from port_bench.trace import kernel_group
from port_bench.work import peaks
from port_bench.work.block12 import b12_work
from port_bench.work.conv import conv_work
from port_bench.work.gram import gram_bwd_work, gram_fwd_work

ITERS = 100            # main-path Adam steps (callback at ITERS // 2)
RERUN_ITERS = 10       # the bit-identical rerun
SIZE = 512
K = 4
K8 = 8                 # the automatic path's masks: max_classes, padded
SEED = 0
GRAM_SHAPES = ((64, 262144), (128, 65536), (256, 16384), (512, 4096),
               (512, 1024))                   # (C, P) of conv1_1..conv5_1
# (C, P) of conv2_1 … conv5_1 at config4's 1024² stage (conv1_1 takes the
# fused pair there): timed, not summed into the 512² step
GRAM_SHAPES_1024 = ((128, 262144), (256, 65536), (512, 16384), (512, 4096))
# (C, P) of conv4_1 and conv5_1 at 4096², where config6's route and the
# standard path take gram_fwd / gram_bwd: timed in bf16, not summed
GRAM_SHAPES_4096 = ((512, 1 << 18), (512, 1 << 16))
POOL_SHAPES = ((64, 512, 512), (128, 256, 256), (256, 128, 128),
               (512, 64, 64))                 # (C, H, W) into pool1..pool4
# (N, C, H, W) of the bias+ReLU of conv1_1 … conv5_1 at 2048² (the 13 convs
# of a step, distinct shapes once), of the batch's 8 pairs at 512², and
# ragged: H·W not a multiple of 8 (planes off their 16-byte boundaries),
# and more planes than a grid has rows (65535)
BIAS_RELU_SHAPES_2048 = ((1, 64, 2048, 2048), (1, 128, 1024, 1024),
                         (1, 256, 512, 512), (1, 512, 256, 256),
                         (1, 512, 128, 128))
BIAS_RELU_SHAPES_BATCH = ((8, 64, 512, 512), (8, 128, 256, 256),
                          (8, 256, 128, 128), (8, 512, 64, 64),
                          (8, 512, 32, 32))
BIAS_RELU_SHAPES_RAGGED = ((3, 5, 7, 9), (2, 64, 33, 37), (1, 3, 1, 1),
                           (7, 10000, 1, 3))
# launches of one config3 step at 2048² and of its precompute (10 convs of
# the content, 13 of the style)
BIAS_RELU_STEP_LAUNCHES = {
    "per_step": {"bias_relu_fwd": 13, "bias_relu_bwd": 13},
    "precompute": {"bias_relu_fwd": 23, "bias_relu_bwd": 0}}
# (Cin, Cout, H = W) of conv1_2 … conv5_1 at 512², the convs that
# conv_impl="pallas" sends to the conv3x3 kernel (conv1_1 stays on cuDNN)
CONV_SHAPES = ((64, 64, 512), (64, 128, 256), (128, 128, 256),
               (128, 256, 128), (256, 256, 128), (256, 256, 128),
               (256, 256, 128), (256, 512, 64), (512, 512, 64),
               (512, 512, 64), (512, 512, 64), (512, 512, 32))
MS_SIZE = 1024                                 # config4's native size
MS_ITERS = (100, 100, 100)                     # Adam steps per config4 stage
RELU_SHAPE = (64, MS_SIZE * MS_SIZE)           # (C, P) of conv1_1 at 1024²
# (C, P) of conv1_1 at 512², where the pallas route takes the fused pair,
# and at 4096², where the standard path takes gram_relu_bwd: timed in bf16,
# not summed into the 1024² step
RELU_SHAPE_512 = (64, SIZE * SIZE)
RELU_SHAPE_4096 = (64, 4096 * 4096)
# (H = W) where lap_matvec is timed besides the 512² step: config4's 1024²
# stage and the 4096² paths
LAP_SIZES = (1024, 4096)
# (C, P) where gram_wbwd runs at 4096²: conv3_1 (config6's stream12 route
# and the standard path) and conv2_1 (the standard path's "auto" stream
# route); bf16, not summed into the 512² pallas route's step
WBWD_SHAPES_4096 = ((256, 1 << 20), (128, 1 << 22))
# fp32 operations per pixel and channel of the matvec: pass 1 (box sums,
# t, b = Λt, α, β) 97, pass 2 (box sums of α and β, the products) 40
LAP_OPS_PER_PIXEL = 3 * 137
POOL_OPS_PER_WINDOW = 13
B12_SIZE = 4096                                # config6 (bench.py): 4096²
B12_ITERS = 10                                 # Adam steps of the route
B12_STD_ITERS = 3                              # the standard path beside it
B12_BATCH = 2          # config6's batch: two pairs (one takes 18.04 GB)
B12_BATCH_ITERS = 5    # its Adam steps
LBFGS_ITERS = 100      # L-BFGS path steps (callback at LBFGS_ITERS // 2)
LBFGS_SHORT = 10       # its reruns, resume halves and 64² reference
SLA_TOL = 0.05         # smooth_local_affine, card against CPU, [0, 255]
SEG_SIZE = 473         # PSPNet's eval size: the segmentation phase's forward
SEG_BATCH = 8          # segment_batch's N and chunk
SEG_LOGIT_TOL = 1e-3   # fp32 logits, card against CPU, of max|logit|
AUTO_ITERS = 100       # automatic path's Adam steps (500 in the preset)
TUNE_ITERS = 50        # autotune: Adam steps a candidate
TUNE_ROUNDS = 2
NIMA_TOL = 1e-4        # fp32 NIMA scores, card against CPU
TUNE_CANDIDATES = 4    # autotune's default Γ: one batch of four a round
BATCH = 8              # the batch path's pairs (BASELINE config 5)
BATCH_ITERS = 100      # its Adam steps (500 in the preset)
# each pair of the batch against the same pair run alone, bf16 on the card,
# where a batch rounds apart from one image (cuDNN chooses its conv
# algorithms per batch size; every batched kernel splits a pair's sums as
# one pair's plan does) and Adam carries the difference on: the first
# history row within
# BATCH_ROW0_TOL of each column's max, every row within BATCH_HIST_TOL,
# the mean |pixel| difference within BATCH_PIXEL_TOL of [0, 255]; the same
# pixel bound holds autotune's best image against `stylize` at its Γ
# (measured on the H100: at most 2.2e-6 of the first row, 1.2e-3 of the
# history and 2.0 of the pixels after 100 steps of the batch; 5.3 for
# autotune's best image at Γ = 1000 after 50 steps)
BATCH_ROW0_TOL = 1e-4
BATCH_PALLAS_ITERS = 20  # the pallas-route batch's steps
BATCH_LBFGS_ITERS = 10   # the L-BFGS batch's steps
BATCH_HIST_TOL = 1e-2
BATCH_PIXEL_TOL = 16.0
# (B, C, P, K, dtype) of the batched kernels' edge checks: the plans' split
# paths with fewer pairs (P split in the forward, the reduction or the
# classes in the backwards), ragged C and P, K = 3, 5 and 9 (gram_relu_bwd
# on gram_wbwd's body past 8 classes and past 64 channels), and the fp32
# tiles
BATCH_EDGE_CASES = ((2, 512, 1024, 4, "bfloat16"),
                    (2, 512, 4096, 3, "bfloat16"),
                    (3, 37, 1001, 5, "bfloat16"),
                    (2, 64, 2048, 9, "bfloat16"),
                    (2, 128, 4096, 4, "bfloat16"),
                    (3, 64, 4096, 4, "float32"),
                    (2, 37, 1001, 3, "float32"))
# (B, C, P, K, dtype) of gram_wbwd's batched edge checks: C = 37 and 128,
# K = 1 … 9, the class splits of a short grid (512 × 1024), the fp32 tile
BATCH_WBWD_EDGES = ((3, 37, 1001, 1, "bfloat16"),
                     (2, 37, 1001, 5, "bfloat16"),
                     (2, 128, 4096, 9, "bfloat16"),
                     (3, 128, 2048, 3, "bfloat16"),
                     (2, 512, 1024, 4, "bfloat16"),
                     (2, 64, 4096, 7, "bfloat16"),
                     (3, 37, 1001, 5, "float32"),
                     (2, 128, 2048, 9, "float32"))
# (B, Cin, Cout, H, W, dtype) of conv3x3's batched edge checks: a plan with
# Cin splits (512 → 512 at 32², B = 2: four splits), ragged widths (the
# scalar epilogue), N tiles of 8 and 104, the fp32 tile
BATCH_CONV_EDGES = ((2, 512, 512, 32, 32, "bfloat16"),
                    (3, 256, 100, 24, 36, "bfloat16"),
                    (2, 70, 40, 17, 33, "bfloat16"),
                    (3, 64, 8, 20, 20, "bfloat16"),
                    (2, 130, 72, 19, 45, "float32"),
                    (3, 16, 24, 9, 13, "float32"))
# (H, W, K, dtype, pooling, ties) of the block12 kernel checks, in the
# bands `band_rows` picks: 256 rows of the 4096-wide image (one band of
# 256), 512 rows (two groups of one band), 320 and 192 rows (groups of
# four bands of 64 stacked: five bands, and three), 96 × 256 (a group of
# three bands of 32), avg pooling, one band with tied maxima, five classes,
# and W = 260 (W/4 = 65: band copies whose rows start off 16-byte
# boundaries, and their scalar tails); the 4096² step shape is checked
# where it is timed
B12_CASES = ((256, 4096, 4, "bfloat16", "max", False),
             (512, 4096, 4, "bfloat16", "max", False),
             (320, 4096, 4, "bfloat16", "max", False),
             (256, 4096, 4, "float32", "max", False),
             (256, 4096, 4, "float32", "avg", False),
             (192, 4096, 4, "float32", "max", False),
             (96, 256, 3, "bfloat16", "avg", False),
             (32, 256, 1, "bfloat16", "max", True),
             (32, 256, 1, "float32", "max", True),
             (64, 256, 5, "bfloat16", "max", False),
             (64, 260, 3, "bfloat16", "max", False),
             (64, 260, 2, "float32", "avg", False))
# (stage, C, bands, own rows a band, W, K, timed) of the checks of the
# backwards' bf16 Gram cotangent stage alone: the shallow and deep groups of
# the 4096² step (one band of 256 own rows; timed), the same at the 32-row
# bands of the TPU kernel (eight a group), then K = 1 and 5 at W = 260 and
# its half, 130 (walked rows that start off 16-byte boundaries)
SP_SIZE = 4096         # the spatial path's image: 4096², as config6
SP_SHARDS = 4          # its row shards (a virtual mesh: all on the one card)
SP_ITERS = 10          # its Adam steps
SP_PROFILE_STEPS = 3   # its profiled steps
SPMD_SIZES = (512, 4096)   # matvec_spmd against the one-device kernel
# 512² bf16 sharded against unsharded, of each column's max: the total
# (column 0) within SP_HIST_TOL, as the JAX package's spatial test holds
# its loss curve; the first row within BATCH_ROW0_TOL and every column
# within BATCH_HIST_TOL, the batch phase's bf16 bounds (Adam's steps turn
# the shards' rounding of a near-zero gradient into ±lr at that pixel, so
# the small terms, content and photoreal, move apart first: 3e-3 and 1.5e-3
# of their max after 10 steps at 128² on the CPU)
SP_HIST_TOL = 1e-3
SP_REF_TOL = 1e-3      # fp32 mesh runs, card against CPU
# the 4096² sharded run's first history row against one unsharded step, of
# each column's max, held to the batch phase's first-row bound: the VGG
# taps are bit-equal, and each shard's bf16 Gram forward and the whole
# image's sum splits of at most gram_stream.FWD_SPLIT_MAX pixels, so
# their accumulations round alike: 1.40e-5 on the style term (before the
# cap the whole image's 63616-pixel splits rounded low: 2.17e-4; NVIDIA
# H100 80GB HBM3, 700.00 W)
SP_ROW0_TOL = BATCH_ROW0_TOL
# the bf16 Grams of conv1_1 … conv5_1 at 4096² against fp64 of the same
# operands, max |error| over max |G|, of the whole image and of the sum of
# the 4 row shards: 1.67-2.83e-5 whole, 1.11-3.02e-5 shards, every mean
# signed error still negative, -1.1e-5 to -2.7e-5 of mean |G| (before the
# cap: 1.92-3.69e-4 whole, the mean at conv1_1 -1.41e-4; 3.8-7.6e-5
# shards; NVIDIA H100 80GB HBM3, 700.00 W)
SP_GRAM_FP64_TOL = {"whole": 1e-4, "shards": 1e-4}
SP_MESH_BATCH = 2      # stylize_batch's virtual mesh of the spatial phase
SP_LBFGS_ITERS = 5     # the 4096² sharded L-BFGS run's steps
# L-BFGS's trajectory bounds (tests/test_golden.py, the L-BFGS golden):
# SSIM of the images, the history's first 10 rows, all its rows; the
# first row (the loss at the start, one evaluation) within LBFGS_ROW0_TOL
# where both sides run one program in fp32
LBFGS_SSIM_MIN, LBFGS_HIST10_RTOL, LBFGS_HIST_RTOL = 0.98, 1e-2, 8e-2
LBFGS_ROW0_TOL = 1e-5
# the sharded objective and its input gradient, card against CPU, at
# single evaluations (of the value; of max |gradient|)
LBFGS_EVAL_TOL = 1e-5
ORACLE_SIZE = 64       # lap_matvec against the fp64 CSR matting Laplacian
# max |error| over max |y| of the fp32 kernel against the fp64 oracle: the
# box sums round in another order and Λ ≈ 1e6 amplifies the roundoff of
# the cancelling terms (tests/test_torch_laplacian.py's bound; 1.21e-6 on
# NVIDIA H100 80GB HBM3, 700.00 W)
ORACLE_TOL = 1e-5
CLI_ITERS = 100        # the cli phase's steps a run (500 in the preset)
CLI_TUNE_ITERS = 50    # its autotune run's steps a candidate
CLI_GAMMAS = ("10", "100", "1000", "10000")   # its --gamma-candidates
CLI_DIR_IMAGES = 8     # the --content-dir run's images
CLI_TIMEOUT_S = 300    # a run's time limit
# (C, P) of conv1_1 … conv5_1 at 4096², K = 4: where the bf16 forward's
# plan caps its splits (gram_stream.FWD_SPLIT_MAX; 63616-65536 pixels a
# split without the cap); each tap's Grams against fp64 of the same bf16
# operands, with and without the cap and at a cap of CAP_ALT, in one call
CAP_SHAPES = ((64, 1 << 24), (128, 1 << 22), (256, 1 << 20),
              (512, 1 << 18), (512, 1 << 16))
CAP_ALT = 4096         # the control cap beside FWD_SPLIT_MAX
CUBLAS_SHAPE = (512, 1 << 18)   # capped max error held to fp32 cuBLAS's
# max |error| over max |G| of the capped bf16 forward against fp64 there:
# 3.86-4.01e-5 of random operands (uncapped 0.87-3.87e-4, fp32 cuBLAS
# 1.73e-4 at (512, 2^18); NVIDIA H100 80GB HBM3, 700.00 W)
GRAM_FP64_TOL = 1e-4
# (B, H, W, dtype, timed) of the batched block12 checks: config6's step
# shape for two pairs, and three pairs of 320 × 4096 (five bands of 64
# rows a pair in groups of four, so that groups run from one pair into the
# next), timed in bf16; the same in fp32, and two pairs of 320 × 4096 in
# bf16
B12_BATCH_CASES = ((2, B12_SIZE, B12_SIZE, "bfloat16", True),
                   (3, 320, 4096, "bfloat16", True),
                   (2, 320, 4096, "bfloat16", False),
                   (3, 320, 4096, "float32", False),
                   (2, B12_SIZE, B12_SIZE, "float32", False))
GRAM_DZ_CASES = (("shallow", 64, 1, 256, 4096, 4, True),
                 ("deep", 128, 1, 256, 2048, 4, True),
                 ("shallow", 64, 8, 32, 4096, 4, False),
                 ("deep", 128, 8, 32, 2048, 4, False),
                 ("shallow", 64, 1, 32, 260, 1, False),
                 ("deep", 128, 3, 32, 130, 5, False),
                 ("shallow", 64, 2, 64, 260, 5, False),
                 ("deep", 128, 1, 64, 130, 1, False))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    print(f"chip_smoke: {phase} failed: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def weights_label() -> str:
    """The VGG bundle a path runs on, or the seeded init that stands in."""
    from dpst_tpu_torch.utils import assets
    path = assets.bundle_path("vgg19")
    return path if os.path.exists(path) else f"He-init seed {SEED}"


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """`peaks.bound_s` in ms, and which of the two bounds it."""
    t = peaks.bound_s(nbytes, ops, dtype)
    by = "bytes" if t == nbytes / peaks.HBM_BYTES_PER_S else "operations"
    return t * 1e3, by


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events, after warm-up; L2 stays warm between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def on_device(ev) -> bool:
    """A profiler event of a kernel or copy on the card. Not a
    `record_function` range's span on the device timeline (the halo
    exchanges' `laplacian_spmd.HALO_RANGE`), which covers its kernels and
    the idle gaps between them."""
    from torch.autograd import DeviceType
    from dpst_tpu_torch.ops.laplacian_spmd import HALO_RANGE
    return (ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name != HALO_RANGE)


def device_events(fn, iters: int, whole, attempts: int = 10) -> list:
    """(name, µs) of each CUDA event (every kernel and copy) of `iters`
    calls of fn under torch.profiler. The card's profiler now and then
    returns a trace that lost events: a trace that `whole(events)` finds
    incomplete is taken again after a pause."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [(ev.name, ev.time_range.elapsed_us()) for ev in prof.events()
               if on_device(ev)]
        if whole(evs):
            return evs
        seen.append(len(evs))
        time.sleep(0.5)
    fail("kernels", f"torch.profiler lost device events {attempts} times "
         f"(events of the traces: {seen})")


def device_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Device time of fn() per call: its CUDA events over `iters` calls,
    after warm-up. Unlike `cuda_ms` it does not count the device idling
    while the host enqueues, which is what back-to-back calls of a wrapper
    around a kernel shorter than its Python measure. fn launches the same
    kernels on every call, so each kernel's name appears a multiple of
    `iters` times in a whole trace. The card's profiler has also returned
    traces one record short, the same in every attempt (19 of 20 events
    in one run), and two short (8 of 10 in every attempt of one run): a
    trace whose names each come at most two short of a multiple is taken,
    a short name counted at the mean of its other launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def by_name(evs) -> dict:
        out: dict[str, list] = {}
        for name, us in evs:
            out.setdefault(name, []).append(us)
        return out

    def whole(evs) -> bool:
        return bool(evs) and all(
            len(v) % iters in (0, iters - 1, iters - 2)
            and len(v) >= iters - 2 for v in by_name(evs).values())

    per = by_name(device_events(fn, iters, whole))
    return sum(sum(v) / len(v) * round(len(v) / iters)
               for v in per.values()) / 1e3


def device_total_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Device time of fn() per call, as every CUDA event of `iters` calls
    (after warm-up) over `iters`, for a whole network's forward: unlike
    `device_ms` it does not ask each kernel's name to come a multiple of
    `iters` times (PSPNet's and NIMA's traces on the card have come a few
    events off)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return sum(us for _, us in device_events(fn, iters, bool)) / iters / 1e3


def in_turns(kernel, library) -> dict:
    """Device and back-to-back event times of a kernel and of the library
    call that computes the same function, taken in turns (kernel, library,
    library, kernel) and averaged per side."""
    k1, l1, l2, k2 = (device_ms(kernel), device_ms(library),
                      device_ms(library), device_ms(kernel))
    return {"ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
            "events_ms": cuda_ms(kernel),
            "library_events_ms": cuda_ms(library)}


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got − ref|, that over max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def out_tol(ref: torch.Tensor, dtype: str) -> float:
    """Tolerance relative to max|ref| of an output rounded once from fp32
    sums taken in two orders: one bf16 ulp at max|ref| in bf16 (at most
    2^-7 = 7.8e-3), 1e-5 in fp32."""
    if dtype == "float32":
        return 1e-5
    top = max(float(ref.float().abs().max()), 1e-30)
    return 2.0 ** (math.floor(math.log2(top)) - 7) / top


def check_lap(dev, gen):
    """lap_matvec at 512² (the step of config3 and the pallas route) and
    at LAP_SIZES (rows with in_step False). "ms" is device time
    (torch.profiler, `device_ms`), "events_ms" back-to-back event time,
    which at 512² follows the host's launch rate; "strip_rows" the kernel's
    plan. The plain version on the card divides by 9 as a product with
    1/9, the kernel as __fdiv_rn does (checked on all floats first): they
    differ in the last bit of some α and β, within the 1e-5 tolerance."""
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    # the kernel divides by 9 in three fused operations: against __fdiv_rn
    # on every float
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    kernels.check(kernels.library().dpst_lap_div9_mismatches(
        kernels.ptr(bad), kernels.stream_ptr(bad)), "lap_div9_mismatches")
    emit({"phase": "kernel", "name": "lap_matvec division by 9",
          "floats_checked": 1 << 32, "mismatches_with_fdiv_rn": int(bad)})
    if int(bad):
        fail("kernels", f"lap_matvec: the division by 9 differs from "
             f"__fdiv_rn at {int(bad)} floats")
    rows = []
    # the larger images from a generator of their own: the later checks
    # draw what they drew before these rows were added
    own = torch.Generator(device=dev).manual_seed(SEED + 8)
    for size, g in ((SIZE, gen),) + tuple((n, own) for n in LAP_SIZES):
        img = torch.rand((size, size, 3), generator=g, device=dev)
        packed = lapc.pack_stats(lap.precompute_stats(img))
        v3 = torch.rand((3, size, size), generator=g, device=dev)
        y = lapc.lap_matvec(packed, v3)
        ref = lapc.lap_matvec_plain(packed, v3)
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        tol = 1e-5
        b, by = bound_ms(20 * size * size * 4,
                         LAP_OPS_PER_PIXEL * size * size, "float32")
        run = lambda: lapc.lap_matvec(packed, v3)
        row = {"phase": "kernel", "name": "lap_matvec",
               "shape": [3, size, size], "dtype": "float32",
               "in_step": size == SIZE, "strip_rows": lapc.lap_plan(size,
                                                                    size),
               "max_abs_err": err, "rel_err": rel, "tol_rel": tol,
               "ms": device_ms(run), "events_ms": cuda_ms(run),
               "plain_ms": cuda_ms(lambda: lapc.lap_matvec_plain(packed,
                                                                 v3),
                                   warmup=1, iters=3),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        emit(row)
        rows.append(row)
        if not rel <= tol:
            fail("kernels", f"lap_matvec {size}²: rel err {rel} > {tol}")
        del img, packed, v3, y, ref
        torch.cuda.empty_cache()
    return rows


def check_lap_oracle(dev) -> None:
    """lap_matvec on the card (fp32, ORACLE_SIZE², stats made on the card)
    against the port's fp64 CSR matting Laplacian (`ops/matting_oracle.
    matvec_oracle`, Levin's matrix assembled window by window on the
    host): an oracle independent of the plain version."""
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    from dpst_tpu_torch.ops import matting_oracle as mo
    r = np.random.default_rng(SEED + 14)
    n = ORACLE_SIZE
    img = r.uniform(0, 1, (n, n, 3)).astype(np.float32)
    v = r.normal(size=(3, n, n)).astype(np.float32)
    packed = lapc.pack_stats(lap.precompute_stats(
        torch.from_numpy(img).to(dev)))
    y = lapc.lap_matvec(packed, torch.from_numpy(v).to(dev)).cpu().numpy()
    ref = mo.matvec_oracle(img.astype(np.float64),
                           v.transpose(1, 2, 0).astype(np.float64)
                           ).transpose(2, 0, 1)
    rel = float(np.abs(y - ref).max() / np.abs(ref).max())
    emit({"phase": "kernel", "name": "lap_matvec", "check":
          "against the fp64 CSR matting Laplacian (ops/matting_oracle.py)",
          "shape": [3, n, n], "dtype": "float32", "rel_err": rel,
          "tol_rel": ORACLE_TOL})
    if not rel <= ORACLE_TOL:
        fail("kernels", f"lap_matvec {n}²: {rel} of max|y| from the fp64 "
             f"oracle")


def check_gram(dev, gen):
    """gram_fwd and gram_bwd (bf16: the wgmma bodies; fp32: the CUDA-core
    tiles) at the 512² taps with K = 4 and with K8 = 8 classes (the
    automatic path's), and in bf16 at config4's 1024² taps and at
    conv4_1 and conv5_1 of 4096² (rows with in_step False, outside the
    512² sums; from generators of their own where new). "ms" and "library_ms" are device
    times (`in_turns`), "events_ms" the back-to-back event times."""
    from dpst_tpu_torch.ops import gram_stream as gs
    rows = []
    # the K = 8 rows (the automatic path's padded masks) from a generator
    # of their own, so the K = 4 rows draw as before
    k8 = torch.Generator(device=dev).manual_seed(SEED + 10)
    big = torch.Generator(device=dev).manual_seed(SEED + 15)
    cases = [("bfloat16", c, p, True, K, gen) for c, p in GRAM_SHAPES]
    cases += [("float32", c, p, True, K, gen) for c, p in GRAM_SHAPES]
    cases += [("bfloat16", c, p, False, K, gen) for c, p in GRAM_SHAPES_1024]
    cases += [(dtype, c, p, True, K8, k8) for dtype in ("bfloat16", "float32")
              for c, p in GRAM_SHAPES]
    cases += [("bfloat16", c, p, False, K, big) for c, p in GRAM_SHAPES_4096]
    for dtype, c, p, in_step, k, rng in cases:
        cdt = getattr(torch, dtype)
        isz = 2 if dtype == "bfloat16" else 4
        f = torch.randn((c, p), generator=rng, device=dev).abs().to(cdt)
        m = torch.rand((k, p), generator=rng, device=dev)
        m2 = (m * m).to(cdt)
        d = torch.randn((k, c, c), generator=rng, device=dev)
        s = (d + d.transpose(1, 2)).to(cdt).contiguous()
        # forward: raw Grams in fp32 from identical bf16/fp32 operands
        g = gs.gram_fwd(f, m2)
        g_ref = gs.gram_fwd_plain(f, m2)
        torch.cuda.synchronize()
        err, rel = rel_err(g, g_ref)
        # fp32 sums of up to 262144 products in two orders (cuBLAS's
        # and the kernel's split-P order): 1.7e-4 of max|G| measured at
        # conv1_1 on the H100 in both dtypes; the errors against a
        # float64 product of the same operands show which side drifts
        tol = 1e-3
        fw64 = (f.unsqueeze(0) * m2.unsqueeze(1)).double()
        g64 = torch.matmul(f.double(), fw64.transpose(1, 2))
        err64 = {"kernel": rel_err(g.double(), g64)[1],
                 "plain": rel_err(g_ref.double(), g64)[1]}
        del fw64, g64
        lib = lambda: torch.matmul(f, f.t().unsqueeze(0) * m2.unsqueeze(2))
        b, by = bound_ms(*gram_fwd_work(c, p, k, isz), dtype)
        row = {"phase": "kernel", "name": "gram_fwd", "shape": [c, p],
               "K": k, "dtype": dtype, "in_step": in_step,
               "max_abs_err": err, "rel_err": rel, "tol_rel": tol,
               "rel_err_fp64": err64,
               **in_turns(lambda: gs.gram_fwd(f, m2), lib),
               "plain_ms": cuda_ms(lambda: gs.gram_fwd_plain(f, m2),
                                   iters=5),
               "bound_ms": b, "bound_by": by}
        emit(row)
        rows.append(row)
        if not rel <= tol:
            fail("kernels", f"gram_fwd {dtype} {c}x{p} K={k}: rel err {rel}")
        # backward: dF in the compute dtype (bf16 output: <= 1 ulp)
        out = gs.gram_bwd(f, m2, s)
        out_ref = gs.gram_bwd_plain(f, m2, s)
        torch.cuda.synchronize()
        err, rel = rel_err(out, out_ref)
        tol = 1e-2 if dtype == "bfloat16" else 1e-4
        a = s.permute(1, 0, 2).reshape(c, k * c)
        lib = lambda: torch.matmul(
            a, (f.unsqueeze(0) * m2.unsqueeze(1)).reshape(k * c, p))
        b, by = bound_ms(*gram_bwd_work(c, p, k, isz), dtype)
        row = {"phase": "kernel", "name": "gram_bwd", "shape": [c, p],
               "K": k, "dtype": dtype, "in_step": in_step,
               "max_abs_err": err, "rel_err": rel, "tol_rel": tol,
               **in_turns(lambda: gs.gram_bwd(f, m2, s), lib),
               "plain_ms": cuda_ms(lambda: gs.gram_bwd_plain(f, m2, s),
                                   iters=5),
               "bound_ms": b, "bound_by": by}
        emit(row)
        rows.append(row)
        if not rel <= tol:
            fail("kernels", f"gram_bwd {dtype} {c}x{p} K={k}: rel err {rel}")
    return rows


def gram_fp64(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """The raw Grams of the bf16 (C, P) f and (K, P) m² in fp64, the
    weighted operand round(F · m²) in bf16 as the kernels form it, summed
    over slices of 2^20 pixels (a bounded fp64 copy)."""
    (c, p), k = f.shape, m2.shape[0]
    out = torch.zeros((k, c, c), dtype=torch.float64, device=f.device)
    for a in range(0, p, 1 << 20):
        fc = f[:, a:a + (1 << 20)]
        f64 = fc.double()
        for q in range(k):
            out[q] += f64 @ (fc * m2[q, a:a + (1 << 20)]).double().T
    return out


def fp64_errors(g: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |g − ref| over max |ref|, and the mean signed error over mean
    |ref| (a bias shows as a mean of one sign)."""
    d = g.double() - ref
    return {"max_rel": float(d.abs().max() / ref.abs().max()),
            "mean_signed_rel": float(d.mean() / ref.abs().mean())}


def plan_at_cap(c: int, p: int, k: int, cap: int | None
                ) -> tuple[int, int]:
    """(splits, chunk) of the bf16 forward of one pair as gram_stream.
    fwd_plan cuts it, with `cap` pixels in place of FWD_SPLIT_MAX (None:
    no cap): one wave of 2 × 132 blocks, splits at least two 128-pixel
    stages deep, and where a split would exceed the cap, enough more,
    raised to fill the grid's last wave. The controls of
    check_gram_split_cap; at FWD_SPLIT_MAX it must be fwd_plan's."""
    from dpst_tpu_torch.ops import gram_stream as gs
    blocks = gs.fwd_blocks(c, k, 1)
    splits = max(1, min(264 // blocks, -(-p // 256)))
    if cap is not None and -(-p // splits) > cap:
        splits = -(-p // cap)
        splits = max(splits, -(-blocks * splits // 264) * 264 // blocks)
    chunk = -(-(-(-p // splits)) // 128) * 128
    return -(-p // chunk), chunk


def fwd_at_plan(name: str, f: torch.Tensor, m2: torch.Tensor, plan,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 forward kernel `name` ("gram_fwd", or "gram_relu_fwd" with
    its bias) on one CUDA (C, P) tap, P a multiple of 8, cut by `plan`
    (splits, chunk) in place of fwd_plan's; not counted in the launch
    counters (a control, never a main path's launch)."""
    from dpst_tpu_torch.ops import kernels
    (c, p), k = f.shape, m2.shape[0]
    splits, chunk = plan
    out = torch.empty((k, c, c), dtype=torch.float32, device=f.device)
    work = torch.empty((1, splits, k, c, c), dtype=torch.float32,
                       device=f.device)
    operands = (f, m2) if bias is None else (f, bias, m2)
    kernels.check(getattr(kernels.library(), "dpst_" + name)(
        *map(kernels.ptr, operands), kernels.ptr(work), kernels.ptr(out),
        c, p, k, 1, splits, chunk, kernels.DTYPE_CODES[f.dtype],
        kernels.stream_ptr(f)), name)
    return out


def gram_cublas_bf16(f: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """The raw Grams of the bf16 (C, P) f and (K, P) m² by cuBLAS's bf16
    GEMM (`torch.mm`) with fp32 accumulation and output, the weighted
    operand round(F · m²) in bf16 as the kernels form it: the card's
    tensor cores under a library."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return torch.stack([torch.mm(f, (f * mk).T, out_dtype=torch.float32)
                            for mk in m2])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved


def plans_in_turns(fns: dict) -> dict:
    """Device ms of each function of `fns`, taken in turns (each in order,
    then in reverse) and averaged per function."""
    ms = dict.fromkeys(fns, 0.0)
    for name in [*fns, *reversed(fns)]:
        ms[name] += device_ms(fns[name]) / 2
    return ms


def check_gram_split_cap(dev, gen):
    """The bf16 forward's cap on a split's length (gram_stream.
    FWD_SPLIT_MAX pixels in the wgmma fp32 accumulators), at the 4096²
    taps (CAP_SHAPES, random operands, K = 4) and for gram_relu_fwd at
    (64, 2^24), beside two controls launched at other plans of the same
    kernel (`plan_at_cap`): no cap (63616-65536 pixels a split) and a cap
    of CAP_ALT pixels. Each plan's Grams and, for gram_fwd, the plain
    version's (fp32 cuBLAS) and bf16 cuBLAS's (fp32 accumulation: the
    card's tensor cores under a library) against fp64, and each plan's
    device time in turns. Held: the capped Grams within GRAM_FP64_TOL
    of max|G|, bit-identical on a rerun; where the cap binds, its max and mean
    signed errors below the uncapped control's (the cap is what lowers
    them); at CUBLAS_SHAPE, its max error at most fp32 cuBLAS's. Launches
    made here are not the main paths' (their counters are reset before
    each path)."""
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    out, bad = [], []

    def control_plans(c, p):
        plans = {"capped": gs.fwd_plan(c, p, K),
                 "uncapped": plan_at_cap(c, p, K, None),
                 f"cap {CAP_ALT}": plan_at_cap(c, p, K, CAP_ALT)}
        if plan_at_cap(c, p, K, gs.FWD_SPLIT_MAX) != plans["capped"]:
            fail("kernels", f"plan_at_cap({c}, {p}) is not fwd_plan's")
        return plans

    def judge(label, errs, plans):
        cap, unc = errs["capped"], errs["uncapped"]
        if not cap["max_rel"] <= GRAM_FP64_TOL:
            bad.append(f"{label}: {cap['max_rel']} of max|G| from fp64")
        if plans["uncapped"][1] > gs.FWD_SPLIT_MAX and not (
                cap["max_rel"] < unc["max_rel"]
                and abs(cap["mean_signed_rel"])
                < abs(unc["mean_signed_rel"])):
            bad.append(f"{label}: the cap does not lower the error "
                       f"({cap} against uncapped {unc})")

    for c, p in CAP_SHAPES:
        f = torch.randn((c, p), generator=gen, device=dev).abs().bfloat16()
        m2 = torch.rand((K, p), generator=gen, device=dev).square(
            ).bfloat16()
        plans = control_plans(c, p)
        ref = gram_fp64(f, m2)
        capped = gs.gram_fwd(f, m2)
        if not torch.equal(capped, gs.gram_fwd(f, m2)):
            bad.append(f"{c}x{p}: a rerun is not bit-identical")
        errs = {"capped": fp64_errors(capped, ref)}
        for name, plan in list(plans.items())[1:]:
            errs[name] = fp64_errors(fwd_at_plan("gram_fwd", f, m2, plan),
                                     ref)
        errs["plain (fp32 cuBLAS)"] = fp64_errors(gs.gram_fwd_plain(f, m2),
                                                  ref)
        errs["bf16 cuBLAS, fp32 accumulation"] = fp64_errors(
            gram_cublas_bf16(f, m2), ref)
        del capped, ref
        judge(f"{c}x{p}", errs, plans)
        if ((c, p) == CUBLAS_SHAPE and not errs["capped"]["max_rel"]
                <= errs["plain (fp32 cuBLAS)"]["max_rel"]):
            bad.append(f"{c}x{p}: above fp32 cuBLAS's error")
        fns = {"capped": lambda: gs.gram_fwd(f, m2)}
        fns.update({name: (lambda plan=plan: fwd_at_plan(
            "gram_fwd", f, m2, plan)) for name, plan in
            list(plans.items())[1:]})
        row = {"phase": "kernel", "check": "gram_fwd split cap",
               "shape": [c, p], "K": K, "dtype": "bfloat16",
               "plans": plans, "fp64": errs, "tol_max_rel": GRAM_FP64_TOL,
               "ms": plans_in_turns(fns)}
        emit(row)
        out.append(row)
        del f, m2
        torch.cuda.empty_cache()
    c, p = RELU_SHAPE_4096
    z, b, m2, _ = relu_gram_input(c, p, K, torch.bfloat16, dev, gen)
    plans = control_plans(c, p)
    ref = gram_fp64(g2._cook(z, b), m2)
    capped = g2.gram_relu_fwd(z, b, m2)
    if not torch.equal(capped, g2.gram_relu_fwd(z, b, m2)):
        bad.append(f"gram_relu_fwd {c}x{p}: a rerun is not bit-identical")
    errs = {"capped": fp64_errors(capped, ref)}
    for name, plan in list(plans.items())[1:]:
        errs[name] = fp64_errors(fwd_at_plan("gram_relu_fwd", z, m2, plan,
                                             b), ref)
    del capped, ref
    judge(f"gram_relu_fwd {c}x{p}", errs, plans)
    fns = {"capped": lambda: g2.gram_relu_fwd(z, b, m2)}
    fns.update({name: (lambda plan=plan: fwd_at_plan(
        "gram_relu_fwd", z, m2, plan, b)) for name, plan in
        list(plans.items())[1:]})
    emit({"phase": "kernel", "check": "gram_relu_fwd split cap",
          "shape": [c, p], "K": K, "dtype": "bfloat16", "plans": plans,
          "fp64": errs, "tol_max_rel": GRAM_FP64_TOL,
          "ms": plans_in_turns(fns)})
    del z, b, m2
    torch.cuda.empty_cache()
    if bad:
        fail("kernels", "gram_fwd split cap: " + "; ".join(bad))
    return out


def check_gram_wbwd(dev, gen):
    """The Gram backward that weights by m² after the product, at the taps
    conv1_1 … conv5_1 of 512² with soft masks (where the weighting enters
    only shows under masks other than 0/1), and in bf16 at the 4096² taps
    of WBWD_SHAPES_4096. On the conv_impl="pallas", gram_impl="pallas" path
    one step launches it at conv2_1 … conv5_1 (conv1_1 takes the fused
    pair); the conv1_1 and 4096² rows are not summed into its step. No
    PyTorch call computes it: the yardstick is gram_bwd's torch.matmul,
    which weights before the product. In bf16 (the Hopper body) "ms" and
    "library_ms" are device times in turns (`in_turns`), "events_ms" the
    back-to-back event times; the fp32 rows (the CUDA-core tile) keep
    event times."""
    from dpst_tpu_torch.ops import gram_pallas as gp
    rows = []
    # the 4096² operands come from a generator of their own: the later
    # checks draw what they drew before these rows were added
    big = torch.Generator(device=dev).manual_seed(SEED + 5)
    cases = [("bfloat16", c, p, c != 64, gen) for c, p in GRAM_SHAPES]
    cases += [("float32", c, p, c != 64, gen) for c, p in GRAM_SHAPES]
    cases += [("bfloat16", c, p, False, big) for c, p in WBWD_SHAPES_4096]
    for dtype, c, p, in_step, gen in cases:
        cdt = getattr(torch, dtype)
        isz = 2 if dtype == "bfloat16" else 4
        f = torch.randn((c, p), generator=gen, device=dev).abs().to(cdt)
        m = torch.rand((K, p), generator=gen, device=dev)
        m2 = (m * m).to(cdt)
        d = torch.randn((K, c, c), generator=gen, device=dev)
        s = (d + d.transpose(1, 2)).to(cdt).contiguous()
        out = gp.gram_wbwd(f, m2, s)
        ref = gp.gram_wbwd_plain(f, m2, s)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = out_tol(ref, dtype)
        a = s.permute(1, 0, 2).reshape(c, K * c)
        lib = lambda: torch.matmul(
            a, (f.unsqueeze(0) * m2.unsqueeze(1)).reshape(K * c, p))
        b, by = bound_ms(*gram_bwd_work(c, p, K, isz), dtype)
        run = lambda: gp.gram_wbwd(f, m2, s)
        times = (in_turns(run, lib) if dtype == "bfloat16" else
                 {"ms": cuda_ms(run), "library_ms": cuda_ms(lib)})
        row = {"phase": "kernel", "name": "gram_wbwd", "shape": [c, p],
               "K": K, "dtype": dtype, "masks": "soft",
               "in_step": in_step, "max_abs_err": err, "rel_err": rel,
               "tol_rel": tol, **times,
               "plain_ms": cuda_ms(lambda: gp.gram_wbwd_plain(f, m2, s),
                                   iters=5),
               "bound_ms": b, "bound_by": by,
               "library_call": "yardstick: gram_bwd's torch.matmul, "
                               "weighting before the product"}
        if dtype == "bfloat16":
            row["plan"] = gp.wbwd_plan(c, p, K)
        emit(row)
        rows.append(row)
        if not rel <= tol:
            fail("kernels", f"gram_wbwd {dtype} {c}x{p}: rel err {rel} "
                 f"> {tol}")
        del f, m2, s, out, ref
        torch.cuda.empty_cache()
    return rows


def conv_operands(cin: int, cout: int, h: int, w: int, dtype, dev, gen):
    """A (Cin, H, W) input, He-scaled OIHW weights and a (Cout, H, W)
    cotangent in `dtype`."""
    x = torch.randn((cin, h, w), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
          * math.sqrt(2.0 / (9 * cin))).to(dtype)
    g = torch.randn((cout, h, w), generator=gen, device=dev).to(dtype)
    return x, wt, g


def check_conv(dev, gen):
    """The 3×3 conv kernel against its plain version at the 12 convs of
    the 512² path and their 12 input gradients (the kernel on the flipped,
    transposed weights), bf16 and fp32, each called as the path calls it:
    on weights packed once (`conv_cuda.pack_weights`). library_ms: cuDNN
    through F.conv2d (forward) and torch.nn.grad.conv2d_input (input
    gradient), with the port's cuDNN flags (deterministic, no TF32 in
    fp32). In bf16 "ms" and "library_ms" are device times in turns
    (`in_turns`), "events_ms" the back-to-back event times; the fp32 rows
    (the CUDA-core tile, outside the step sums) keep event times. A shape
    the step repeats (conv3_2 … conv3_4, conv4_2 … conv4_4) is checked on
    its own operands and timed once; its later rows carry that time
    ("timed_with_row")."""
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import conv_cuda as cc
    rows = []
    timed = {}
    for dtype in ("bfloat16", "float32"):
        cdt = getattr(torch, dtype)
        isz = 2 if dtype == "bfloat16" else 4
        vgg.set_exact_backends(cdt)
        for cin, cout, hw in CONV_SHAPES:
            x, wt, g = conv_operands(cin, cout, hw, hw, cdt, dev, gen)
            ft = cc.flip_transpose_weights(wt)
            cases = (
                ("forward", x, wt, "F.conv2d",
                 lambda: F.conv2d(x[None], wt, padding=1)),
                ("input_grad", g, ft, "torch.nn.grad.conv2d_input",
                 lambda: torch.nn.grad.conv2d_input(
                     (1, cin, hw, hw), wt, g[None], padding=1)))
            for direction, a, b, lib_name, lib in cases:
                bp = cc.pack_weights(b)
                run = lambda: cc.conv3x3_same(a, bp)
                y = run()
                ref = cc.conv3x3_plain(a, b)
                torch.cuda.synchronize()
                err, rel = rel_err(y, ref)
                tol = out_tol(ref, dtype)
                k_in, k_out = b.shape[1], b.shape[0]
                bnd, by = bound_ms(*conv_work(k_in, k_out, hw, hw, isz),
                                   dtype)
                key = (dtype, direction, k_in, k_out, hw)
                if key not in timed:
                    timed[key] = (len(rows), {
                        **(in_turns(run, lib) if dtype == "bfloat16" else
                           {"ms": cuda_ms(run), "library_ms": cuda_ms(lib)}),
                        "plain_ms": cuda_ms(lambda: cc.conv3x3_plain(a, b),
                                            iters=5)})
                first, times = timed[key]
                row = {"phase": "kernel", "name": "conv3x3",
                       "direction": direction, "shape": [k_in, k_out, hw, hw],
                       "dtype": dtype, "max_abs_err": err, "rel_err": rel,
                       "tol_rel": tol, **times,
                       "bound_ms": bnd, "bound_by": by,
                       "library_call": lib_name}
                if first != len(rows):
                    row["timed_with_row"] = first
                if dtype == "bfloat16":
                    row["plan"] = cc.conv_plan(k_in, k_out, hw, hw)
                emit(row)
                rows.append(row)
                if not rel <= tol:
                    fail("kernels", f"conv3x3 {direction} {dtype} "
                         f"{k_in}->{k_out} at {hw}²: rel err {rel} > {tol}")
            del x, wt, g, ft, y, ref, bp
        torch.cuda.empty_cache()
    return rows


def relu_gram_input(c: int, p: int, k: int, dtype, dev, gen):
    """A raw conv1_1-like tap z with about 1 % of entries at z = −b (exact
    zeros of z + b, the relu′ = ½ case), its bias b, m² of K soft masks and
    a symmetrized cotangent."""
    b = (0.5 * torch.randn((c,), generator=gen, device=dev)).to(dtype)
    z = torch.randn((c, p), generator=gen, device=dev).to(dtype)
    tie = torch.rand((c, p), generator=gen, device=dev) < 0.01
    z = torch.where(tie, -b[:, None].expand(c, p), z).contiguous()
    m = torch.rand((k, p), generator=gen, device=dev)
    m2 = (m * m).to(dtype)
    d = torch.randn((k, c, c), generator=gen, device=dev)
    s = (d + d.transpose(1, 2)).to(dtype).contiguous()
    return z, b, m2, s


def check_gram_relu(dev, gen):
    """The fused bias+ReLU Gram pair at conv1_1 of the 1024² stage, and in
    bf16 at conv1_1 of 512² (the pallas route's) and, the backward only, of
    4096² (the standard path's); those rows are not summed into the 1024²
    step. No PyTorch call computes bias + ReLU + masked Grams; the
    yardstick is the gram_fwd / gram_bwd rows' torch.matmul on the
    already-cooked operand relu(z + b), which does strictly less work. The
    bf16 kernels (the forward: gram_fwd's Hopper body with a bias+ReLU
    prologue; the backward: gram_relu_bwd64_body) are timed by device time
    in turns with it (`in_turns`), and beside the same work in separate
    launches: "cook with torch, then gram_fwd", and "cook with torch, then
    gram_wbwd, then relu′"."""
    from dpst_tpu_torch.ops import gram_pallas as gp
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    rows = []
    # the 512² and 4096² operands from generators of their own (as in
    # check_gram_wbwd)
    own = torch.Generator(device=dev).manual_seed(SEED + 6)
    big = torch.Generator(device=dev).manual_seed(SEED + 9)
    # K = 8 at conv1_1 of 512²: the autotune sweep's fused pair
    k8 = torch.Generator(device=dev).manual_seed(SEED + 11)
    for dtype, (c, p), in_step, gen, fwd, k in (
            ("bfloat16", RELU_SHAPE, True, gen, True, K),
            ("float32", RELU_SHAPE, True, gen, True, K),
            ("bfloat16", RELU_SHAPE_512, False, own, True, K),
            ("bfloat16", RELU_SHAPE_4096, False, big, False, K),
            ("bfloat16", RELU_SHAPE_512, True, k8, True, K8),
            ("float32", RELU_SHAPE_512, True, k8, True, K8)):
        cdt = getattr(torch, dtype)
        isz = 2 if dtype == "bfloat16" else 4
        z, b, m2, s = relu_gram_input(c, p, k, cdt, dev, gen)
        zeros = int(((z.float() + b.float()[:, None]) == 0).sum())
        ops = 2.0 * k * c * c * p
        f = g2._cook(z, b)
        if fwd:
            rows.append(check_gram_relu_fwd(z, b, m2, f, dtype, in_step,
                                            zeros, k))
        out = g2.gram_relu_bwd(z, b, m2, s)
        out_ref = g2.gram_relu_bwd_plain(z, b, m2, s)
        torch.cuda.synchronize()
        err, rel = rel_err(out, out_ref)
        # bf16: one ulp of max|dz| (fp32 class products summed in two
        # orders, rounded once), as gram_wbwd
        tol = out_tol(out_ref, dtype) if dtype == "bfloat16" else 1e-4
        del out, out_ref
        a = s.permute(1, 0, 2).reshape(c, k * c)
        lib = lambda: torch.matmul(
            a, (f.unsqueeze(0) * m2.unsqueeze(1)).reshape(k * c, p))
        bnd, by = bound_ms((2 * c * p + k * p + k * c * c + c) * isz, ops,
                           dtype)
        run = lambda: g2.gram_relu_bwd(z, b, m2, s)
        if dtype == "bfloat16":
            times = in_turns(run, lib)
            two = lambda: (gp.gram_wbwd(g2._cook(z, b), m2, s).float()
                           * g2._relu_grad(z, b)).to(cdt)
            times["same_work"] = {
                "call": "cook with torch, then gram_wbwd, then relu′",
                "ms": device_ms(two), "events_ms": cuda_ms(two)}
            times["plan"] = g2.relu_bwd_plan(c, p, k)
        else:
            times = {"ms": cuda_ms(run), "library_ms": cuda_ms(lib)}
        row = {"phase": "kernel", "name": "gram_relu_bwd", "shape": [c, p],
               "K": k, "dtype": dtype, "in_step": in_step,
               "exact_zeros": zeros, "max_abs_err": err, "rel_err": rel,
               "tol_rel": tol, **times,
               "plain_ms": cuda_ms(
                   lambda: g2.gram_relu_bwd_plain(z, b, m2, s), warmup=1,
                   iters=3),
               "bound_ms": bnd, "bound_by": by,
               "library_call": "yardstick: gram_bwd's torch.matmul on "
                               "relu(z + b), less work"}
        emit(row)
        rows.append(row)
        if not rel <= tol:
            fail("kernels", f"gram_relu_bwd {dtype} {c}x{p} K={k}: rel err "
                 f"{rel} > {tol}")
        del z, b, m2, s, f
        torch.cuda.empty_cache()
    return rows


def check_gram_relu_fwd(z, b, m2, f, dtype: str, in_step: bool,
                        zeros: int, k: int) -> dict:
    """The forward half of `check_gram_relu` on its operands (k classes)."""
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    (c, p), isz = z.shape, z.element_size()
    ops = 2.0 * k * c * c * p
    g = g2.gram_relu_fwd(z, b, m2)
    g_ref = g2.gram_relu_fwd_plain(z, b, m2)
    torch.cuda.synchronize()
    err, rel = rel_err(g, g_ref)
    # as gram_fwd: fp32 sums of 1048576 products in two orders; the
    # errors against a float64 product of the same operands show which
    # side drifts
    tol = 1e-3
    fw64 = (f.unsqueeze(0) * m2.unsqueeze(1)).double()
    g64 = torch.matmul(f.double(), fw64.transpose(1, 2))
    err64 = {"kernel": rel_err(g.double(), g64)[1],
             "plain": rel_err(g_ref.double(), g64)[1]}
    del fw64, g64
    lib = lambda: torch.matmul(f, f.t().unsqueeze(0) * m2.unsqueeze(2))
    bnd, by = bound_ms((c * p + k * p + c) * isz + k * c * c * 4, ops,
                       dtype)
    run = lambda: g2.gram_relu_fwd(z, b, m2)
    if dtype == "bfloat16":
        times = in_turns(run, lib)
        two = lambda: gs.gram_fwd(g2._cook(z, b), m2)
        times["same_work"] = {"call": "cook with torch, then gram_fwd",
                              "ms": device_ms(two),
                              "events_ms": cuda_ms(two)}
    else:
        times = {"ms": cuda_ms(run), "library_ms": cuda_ms(lib)}
    row = {"phase": "kernel", "name": "gram_relu_fwd", "shape": [c, p],
           "K": k, "dtype": dtype, "in_step": in_step,
           "exact_zeros": zeros, "max_abs_err": err, "rel_err": rel,
           "tol_rel": tol, "rel_err_fp64": err64, **times,
           "plain_ms": cuda_ms(lambda: g2.gram_relu_fwd_plain(z, b, m2),
                               iters=5),
           "bound_ms": bnd, "bound_by": by,
           "library_call": "yardstick: gram_fwd's torch.matmul on "
                           "relu(z + b), less work"}
    emit(row)
    if not rel <= tol:
        fail("kernels", f"gram_relu_fwd {dtype} {c}x{p} K={k}: rel err "
             f"{rel}")
    del g, g_ref
    return row


def tied_pool_input(c: int, h: int, w: int, dtype, dev, gen):
    """Post-ReLU-like values on a coarse grid (many tied maxima), their 2×2
    max pool and a cotangent."""
    x = torch.relu(torch.round(torch.randn(
        (c, h, w), generator=gen, device=dev) * 4) / 4).to(dtype)
    y = F.max_pool2d(x[None], 2, 2)[0].contiguous()
    g = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    return x, y, g


def check_pool(dev, gen):
    from dpst_tpu_torch.ops import pool_cuda
    rows = []
    for dtype in ("bfloat16", "float32"):
        isz = 2 if dtype == "bfloat16" else 4
        for c, h, w in POOL_SHAPES:
            x, y, g = tied_pool_input(c, h, w, getattr(torch, dtype), dev,
                                      gen)
            gx = pool_cuda.maxpool2_bwd(x, y, g)
            ref = pool_cuda.maxpool2_bwd_plain(x, y, g)
            torch.cuda.synchronize()
            equal = bool(torch.equal(gx, ref))
            n = c * h * w
            b, by = bound_ms(2.5 * n * isz, POOL_OPS_PER_WINDOW * n / 4,
                             dtype)
            run = lambda: pool_cuda.maxpool2_bwd(x, y, g)
            row = {"phase": "kernel", "name": "pool_bwd",
                   "shape": [c, h, w], "dtype": dtype,
                   "max_abs_err": rel_err(gx, ref)[0], "bit_equal": equal,
                   "tol": "bit-exact", "ms": device_ms(run),
                   "events_ms": cuda_ms(run),
                   "plain_ms": cuda_ms(
                       lambda: pool_cuda.maxpool2_bwd_plain(x, y, g),
                       iters=5),
                   "bound_ms": b, "bound_by": by, "library_ms": None}
            emit(row)
            rows.append(row)
            if not equal:
                fail("kernels", f"pool_bwd {dtype} {c}x{h}x{w} not "
                     f"bit-equal (max err {row['max_abs_err']})")
    return rows


def bias_relu_input(shape, dtype, dev, gen):
    """z with exact zeros of z + b (z = -b in the dtype), -0.0 (channel 0's
    bias is -0.0, so -0 + -0 stays -0), ±inf and NaN; b; a cotangent g."""
    c = shape[-3]
    b = (torch.randn((c,), generator=gen, device=dev) * 0.5).to(dtype)
    b[0] = -0.0
    z = torch.randn(shape, generator=gen, device=dev).to(dtype)
    zero = torch.rand(shape, generator=gen, device=dev) < 0.1
    z = torch.where(zero, -b[:, None, None].expand(shape), z).contiguous()
    flat = z.view(-1)
    n = flat.numel()
    flat[0] = -0.0
    for i, v in enumerate((-0.0, float("nan"), float("inf"),
                           -float("inf")), start=1):
        flat[i * n // 5] = v
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return z, b, g


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (signed zeros and NaN payloads included)."""
    as_int = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a.view(as_int), b.view(as_int))))


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """t's values in a view one element into a larger buffer: every plane
    starts off its 16-byte boundary, and off that of a fresh output."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_bias_relu(dev, gen) -> None:
    """The bias+ReLU kernels (ops/bias_relu_cuda.py) against their plain
    versions, the ATen composite they replace, bit for bit: at the 13 conv
    shapes of a 2048² step (BIAS_RELU_SHAPES_2048), the batch's
    (8, C, H, W) at 512² and ragged or misaligned shapes, in bf16 and fp32;
    each kernel timed by device time and by events against its byte bound
    (read z and write y; read z and g and write dz). Then the launches of
    one 2048² config3 step (BIAS_RELU_STEP_LAUNCHES)."""
    from dpst_tpu_torch.ops import bias_relu_cuda as br
    cases = ([(s, "2048² step", True) for s in BIAS_RELU_SHAPES_2048]
             + [(s, "batch 512²", True) for s in BIAS_RELU_SHAPES_BATCH]
             + [(s, "ragged", False) for s in BIAS_RELU_SHAPES_RAGGED])
    for dtype in ("bfloat16", "float32"):
        isz = 2 if dtype == "bfloat16" else 4
        for shape, where, timed in cases:
            z, b, g = bias_relu_input(shape, getattr(torch, dtype), dev, gen)
            y, dz = br.bias_relu_fwd(z, b), br.bias_relu_bwd(z, b, g)
            equal = {
                "fwd": same_bits(y, br.bias_relu_fwd_plain(z, b)),
                "bwd": same_bits(dz, br.bias_relu_bwd_plain(z, b, g))}
            if not timed:
                # planes off their 16-byte boundaries, the tensors apart
                zo, go = offset_copy(z), offset_copy(g)
                equal["fwd offset"] = same_bits(br.bias_relu_fwd(zo, b), y)
                equal["bwd offset"] = same_bits(
                    br.bias_relu_bwd(zo, b, go), dz)
            torch.cuda.synchronize()
            n = z.numel()
            for name in ("bias_relu_fwd", "bias_relu_bwd"):
                fwd = name == "bias_relu_fwd"
                row = {"phase": "kernel", "name": name, "shape": list(shape),
                       "case": where, "dtype": dtype, "tol": "bit-exact",
                       "bit_equal": {k: v for k, v in equal.items()
                                     if k.startswith(name[-3:])}}
                if timed:
                    run = ((lambda: br.bias_relu_fwd(z, b)) if fwd
                           else (lambda: br.bias_relu_bwd(z, b, g)))
                    plain = ((lambda: br.bias_relu_fwd_plain(z, b)) if fwd
                             else (lambda: br.bias_relu_bwd_plain(z, b, g)))
                    bound, by = bound_ms((2 if fwd else 3) * n * isz,
                                         (2 if fwd else 3) * n, dtype)
                    ms = device_ms(run)
                    row.update({"ms": ms, "events_ms": cuda_ms(run),
                                "plain_ms": device_ms(plain, iters=5),
                                "bound_ms": bound, "bound_by": by,
                                "share_of_bound": bound / ms})
                emit(row)
            if not all(equal.values()):
                fail("kernels", f"bias_relu {dtype} {list(shape)} not "
                     f"bit-equal: {equal}")
            del z, b, g, y, dz
    bias_relu_step_launches(dev)


def bias_relu_step_launches(dev) -> None:
    """The bias+ReLU launches of one Adam step of config3 at 2048² (the
    standard path, 13 convs to conv5_1 each way), as the difference of a
    3-step and a 1-step `stylize` (each with its precompute: the content
    to conv4_2 and the style to conv5_1, forwards only)."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    size = 2048
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    content = smooth_image(gen, dev, size).cpu().numpy()
    style = textured_image(gen, dev, size).cpu().numpy()
    cmask, smask = band_masks(K, size, 0, 0), band_masks(K, size, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)
    counts = {}
    for steps in (1, 3):
        cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                                  iterations=steps)
        kernels.reset_launches()
        dpst_tpu_torch.stylize(content, style, cfg, content_masks=cmask,
                               style_masks=smask, vgg_params=params)
        counts[steps] = {k: kernels.LAUNCHES[k]
                         for k in ("bias_relu_fwd", "bias_relu_bwd")}
    per_step = {k: (counts[3][k] - counts[1][k]) // 2 for k in counts[1]}
    precompute = {k: counts[1][k] - per_step[k] for k in counts[1]}
    row = {"phase": "kernel", "check": "bias_relu launches", "size": size,
           "per_step": per_step, "precompute": precompute,
           "expected": BIAS_RELU_STEP_LAUNCHES}
    emit(row)
    if {"per_step": per_step, "precompute": precompute} != \
            BIAS_RELU_STEP_LAUNCHES:
        fail("kernels", f"bias_relu launches at 2048²: {row}")


# conv shapes whose plans make a block sum two chunks of Cin: (Cin, Cout,
# H, W) -> the (bn, splits, cps) of the forward and of the input gradient
CONV_MULTI_PLANS = {(256, 40, 128, 128): ((40, 2, 2), (128, 1, 1)),
                    (256, 100, 128, 128): ((104, 2, 2), (128, 1, 2)),
                    (256, 64, 128, 128): ((64, 2, 2), (128, 1, 1))}


def check_edges(dev, gen) -> None:
    """Each kernel against its plain version at shapes that do not fill
    its tiles (C not a multiple of 64 or of 8, odd P, odd pool sizes, an
    image smaller than one Laplacian tile, conv images smaller than one
    tile or ragged in H, W, Cin and Cout: Cin not a multiple of the
    64-channel chunk (nor of 8: 100), Cout = 3, 40 and 100 on N tiles of
    8, 40 and 104, W not a multiple of the 32-pixel tile, H = 1), with the
    tolerances above, and
    the conv's split-Cin plan (512 → 512 at 32²) rerun bit for bit, as
    are the shapes of CONV_MULTI_PLANS, whose blocks sum two chunks of
    Cin on N tiles of 40, 104, 64 and 128 (the plan asserted).
    block12's conv1_1 in its packed-K form runs at B12_CASES' one-band 32
    × 256 case and the others."""
    from dpst_tpu_torch.ops import conv_cuda as cc
    from dpst_tpu_torch.ops import gram_pallas as gp
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    from dpst_tpu_torch.ops import pool_cuda

    errs = {}
    for h, w in ((37, 53), (5, 7)):
        img = torch.rand((h, w, 3), generator=gen, device=dev)
        packed = lapc.pack_stats(lap.precompute_stats(img))
        v3 = torch.rand((3, h, w), generator=gen, device=dev)
        errs[f"lap_matvec {h}x{w}"] = (rel_err(
            lapc.lap_matvec(packed, v3),
            lapc.lap_matvec_plain(packed, v3))[1], 1e-5)
    for dtype in ("bfloat16", "float32"):
        cdt = getattr(torch, dtype)
        # odd P (padded to 8 by the bf16 wrappers), P below one 64-pixel
        # tile, C not a multiple of 8, five classes (two class groups), and
        # odd class counts over many stages (the forward's two weighted
        # fragment buffers alternate across a stage's halves)
        for c, p, k in ((96, 1000, 3), (8, 40, 1), (200, 3000, 5),
                        (96, 1001, 3), (512, 9, 4), (37, 333, 2),
                        (64, 8192, 1), (256, 8192, 3)):
            f = torch.randn((c, p), generator=gen, device=dev).abs().to(cdt)
            m2 = torch.rand((k, p), generator=gen, device=dev).to(cdt)
            d = torch.randn((k, c, c), generator=gen, device=dev)
            s = (d + d.transpose(1, 2)).to(cdt).contiguous()
            errs[f"gram_fwd {dtype} {c}x{p} K={k}"] = (rel_err(
                gs.gram_fwd(f, m2), gs.gram_fwd_plain(f, m2))[1], 1e-3)
            errs[f"gram_bwd {dtype} {c}x{p} K={k}"] = (rel_err(
                gs.gram_bwd(f, m2, s), gs.gram_bwd_plain(f, m2, s))[1],
                1e-2 if dtype == "bfloat16" else 1e-4)
            ref = gp.gram_wbwd_plain(f, m2, s)
            errs[f"gram_wbwd {dtype} {c}x{p} K={k}"] = (rel_err(
                gp.gram_wbwd(f, m2, s), ref)[1], out_tol(ref, dtype))
            z, b, m2, s = relu_gram_input(c, p, k, cdt, dev, gen)
            errs[f"gram_relu_fwd {dtype} {c}x{p} K={k}"] = (rel_err(
                g2.gram_relu_fwd(z, b, m2),
                g2.gram_relu_fwd_plain(z, b, m2))[1], 1e-3)
            ref = g2.gram_relu_bwd_plain(z, b, m2, s)
            errs[f"gram_relu_bwd {dtype} {c}x{p} K={k}"] = (rel_err(
                g2.gram_relu_bwd(z, b, m2, s), ref)[1],
                out_tol(ref, dtype) if dtype == "bfloat16" else 1e-4)
        for cin, cout, h, w in ((24, 40, 37, 53), (512, 512, 4, 4),
                                (8, 16, 4, 4), (72, 64, 20, 40),
                                (64, 3, 48, 256), (64, 40, 33, 70),
                                (128, 64, 1, 100), (64, 100, 20, 40),
                                (512, 512, 32, 32), *CONV_MULTI_PLANS):
            x, wt, g = conv_operands(cin, cout, h, w, cdt, dev, gen)
            ft = cc.flip_transpose_weights(wt)
            plans = CONV_MULTI_PLANS.get((cin, cout, h, w))
            for i, (direction, a, b) in enumerate((("forward", x, wt),
                                                   ("input_grad", g, ft))):
                ref = cc.conv3x3_plain(a, b)
                y = cc.conv3x3_same(a, b)
                name = f"conv3x3 {direction} {dtype} {cin}->{cout} {h}x{w}"
                errs[name] = (rel_err(y, ref)[1], out_tol(ref, dtype))
                if plans:
                    plan = cc.conv_plan(a.shape[0], b.shape[0], h, w)
                    if plan != plans[i]:
                        fail("kernel_edges", f"{name}: plan {plan}, "
                             f"expected {plans[i]}")
                if plans or (cin == cout == 512 and h == 32):
                    same = all(torch.equal(y, cc.conv3x3_same(a, b))
                               for _ in range(2))
                    errs[name + " rerun"] = (0.0 if same else 1.0, 0.0)
        for c, h, w in ((3, 17, 15), (5, 16, 15), (2, 3, 3)):
            x, y, g = tied_pool_input(c, h, w, cdt, dev, gen)
            equal = torch.equal(pool_cuda.maxpool2_bwd(x, y, g),
                                pool_cuda.maxpool2_bwd_plain(x, y, g))
            errs[f"pool_bwd {dtype} {c}x{h}x{w}"] = (0.0 if equal else 1.0,
                                                     0.0)
    # the relu forward at C = 37 with every b > 0: the rows of its 64-row
    # tile past C take no bias (b has C entries), and the pixels past P,
    # padded or zero-filled, cook to relu(b) > 0 under zero masks; operands
    # from a generator of their own, so the cases above draw as before
    own = torch.Generator(device=dev).manual_seed(SEED + 7)
    for dtype in ("bfloat16", "float32"):
        cdt = getattr(torch, dtype)
        for c, p, k in ((37, 1001, 3), (37, 4099, 5)):
            z, b, m2, _ = relu_gram_input(c, p, k, cdt, dev, own)
            b = (b.float().abs() + 0.25).to(cdt)
            errs[f"gram_relu_fwd {dtype} {c}x{p} K={k} b>0"] = (rel_err(
                g2.gram_relu_fwd(z, b, m2),
                g2.gram_relu_fwd_plain(z, b, m2))[1], 1e-3)
    # the bias+ReLU backward past the C <= 64 body's RELU_BWD_MAX_K classes
    # (gram_wbwd's body at C = 64, its nine classes split three and nine
    # ways), and the C <= 64 body at p tiles that pass P and at K = 8, the
    # most it keeps; its own generator as above
    for c, p, k in ((64, 4096, 9), (64, 520, 9), (64, 1000, 8),
                    (48, 2056, 5)):
        z, b, m2, s = relu_gram_input(c, p, k, torch.bfloat16, dev, own)
        ref = g2.gram_relu_bwd_plain(z, b, m2, s)
        errs[f"gram_relu_bwd bfloat16 {c}x{p} K={k} "
             f"plan={g2.relu_bwd_plan(c, p + -p % 8, k)}"] = (rel_err(
                 g2.gram_relu_bwd(z, b, m2, s), ref)[1],
                 out_tol(ref, "bfloat16"))
    # lap_matvec where the plan gives strips of two rows (the sizes above
    # take one) and at an image one strip wide
    for h, w in ((300, 200), (129, 30)):
        img = torch.rand((h, w, 3), generator=own, device=dev)
        packed = lapc.pack_stats(lap.precompute_stats(img))
        v3 = torch.rand((3, h, w), generator=own, device=dev)
        errs[f"lap_matvec {h}x{w} rows={lapc.lap_plan(h, w)}"] = (rel_err(
            lapc.lap_matvec(packed, v3),
            lapc.lap_matvec_plain(packed, v3))[1], 1e-5)
    torch.cuda.synchronize()
    emit({"phase": "kernel_edges", "rel_err_and_tol": errs})
    bad = [name for name, (e, tol) in errs.items() if not e <= tol]
    if bad:
        fail("kernel_edges", "beyond tolerance: " + ", ".join(bad))


def b12_forward_input(h: int, w: int, k: int, dev, gen, ties: bool = False):
    """A preprocessed-range image (3, H, W) fp32 (constant on 8 × 8 patches
    with `ties`, so that pooled windows hold tied maxima), m1² (K, H, W)
    and m2² (K, H/2, W/2) of soft masks."""
    if ties:
        x = (torch.rand((3, h // 8, w // 8), generator=gen, device=dev)
             * 250 - 120).repeat_interleave(8, 1).repeat_interleave(8, 2)
    else:
        x = torch.rand((3, h, w), generator=gen, device=dev) * 250 - 120
    m1 = torch.rand((k, h, w), generator=gen, device=dev) ** 2
    m2 = torch.rand((k, h // 2, w // 2), generator=gen, device=dev) ** 2
    return x.contiguous(), m1, m2


def b12_shallow_input(h: int, w: int, k: int, params: dict, dtype, dev,
                      gen):
    """Inputs of the shallow backward on which both versions recompute
    conv1_2 exactly: a11 of small integers (0…3, many zeros), conv1_2's
    weights in {−1, 0, 1} and integer biases (the weights packed again),
    so every fp32 sum is exact and tied maxima tie on both sides; a dp1
    cotangent and s1."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    a11 = torch.randint(0, 4, (64, h, w), generator=gen, device=dev)
    w12 = torch.randint(-1, 2, (64, 64, 3, 3), generator=gen, device=dev)
    b12w = torch.randint(-8, 9, (64,), generator=gen, device=dev)
    wts = b12.pack_weights(dict(params, conv1_2={"w": w12.float(),
                                                 "b": b12w.float()}), dtype)
    cdt = getattr(torch, dtype)
    dp1 = torch.randn((64, h // 2, w // 2), generator=gen,
                      device=dev).to(cdt)
    dg1 = torch.randn((k, 64, 64), generator=gen, device=dev)
    return a11.to(cdt), dp1, wts, dg1


def b12_copy_bytes(h: int, w: int, k: int, isz: int) -> dict:
    """Bytes each block12 entry point's band copies must move at an H × W
    image with K classes, each element read once and written once: a
    gathered band stacks tb + 2·HALO rows for tb own rows (tb =
    `band_rows(h, w)`: 1.0625× at 4096², 1.5× at 32 rows; the rows outside
    the image are only written), a scatter moves the own rows; the image,
    masks and dx in fp32, the rest in the compute dtype."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    tb = b12.band_rows(h, w)
    p, p2, p4 = h * w, h * w // 4, h * w // 16
    stack = (tb + 2 * b12.HALO) / tb
    fwd = 3 * p * stack * (4 + isz) + 128 * p4 * 2 * isz
    res = (64 * p + 2 * 128 * p2) * 2 * isz
    deep = (stack * (2 * 128 * p2 + 128 * p4) * 2 * isz
            + stack * k * p2 * (4 + isz) + 64 * p2 * (4 + isz))
    shallow = (stack * (64 * p + 64 * p2) * 2 * isz
               + stack * k * p * (4 + isz) + 3 * p * 8)
    return {"block12_fwd": fwd, "block12_fwd_res": fwd + res,
            "block12_bwd_deep": deep, "block12_bwd_shallow": shallow}


def b12_cudnn(h: int, w: int, params: dict, dtype, n: int = 1) -> dict:
    """Labelled yardsticks that do less work than each entry point: cuDNN
    on the same convs at the same shapes (no bias, ReLU, pools, masks or
    Grams), on a batch of n images. Forward: conv1_1 … conv2_2; deep
    backward: the input gradients of conv2_2 and conv2_1; shallow
    backward: the conv1_2 forward and the input gradients of conv1_2 and
    conv1_1."""
    dev = params["conv1_1"]["w"].device
    wt = {name: params[name]["w"].to(dtype)
          for name in ("conv1_1", "conv1_2", "conv2_1", "conv2_2")}
    x0 = torch.zeros((n, 3, h, w), dtype=dtype, device=dev)
    x1 = torch.zeros((n, 64, h, w), dtype=dtype, device=dev)
    x2 = torch.zeros((n, 64, h // 2, w // 2), dtype=dtype, device=dev)
    x3 = torch.zeros((n, 128, h // 2, w // 2), dtype=dtype, device=dev)
    grad_in = torch.nn.grad.conv2d_input

    def fwd():
        F.conv2d(x0, wt["conv1_1"], padding=1)
        F.conv2d(x1, wt["conv1_2"], padding=1)
        F.conv2d(x2, wt["conv2_1"], padding=1)
        F.conv2d(x3, wt["conv2_2"], padding=1)

    def deep():
        grad_in(x3.shape, wt["conv2_2"], x3, padding=1)
        grad_in(x2.shape, wt["conv2_1"], x3, padding=1)

    def shallow():
        F.conv2d(x1, wt["conv1_2"], padding=1)
        grad_in(x1.shape, wt["conv1_2"], x1, padding=1)
        grad_in(x0.shape, wt["conv1_1"], x1, padding=1)

    ms = {name: cuda_ms(fn, warmup=2, iters=5) for name, fn in (
        ("fwd", fwd), ("deep", deep), ("shallow", shallow))}
    return {"block12_fwd": ms["fwd"], "block12_fwd_res": ms["fwd"],
            "block12_bwd_deep": ms["deep"],
            "block12_bwd_shallow": ms["shallow"]}


B12_YARDSTICK = {
    "block12_fwd": "yardstick: cuDNN conv1_1…conv2_2 forward, less work",
    "block12_fwd_res": "yardstick: cuDNN conv1_1…conv2_2 forward, less work",
    "block12_bwd_deep": "yardstick: cuDNN input gradients of conv2_2 and "
                        "conv2_1, less work",
    "block12_bwd_shallow": "yardstick: cuDNN conv1_2 forward and input "
                           "gradients of conv1_2 and conv1_1, less work"}


B12_OUTS = {"block12_fwd": ("g1", "g2", "p2"),
            "block12_fwd_res": ("g1", "g2", "p2", "a11", "a21", "a22"),
            "block12_bwd_deep": ("dp1",), "block12_bwd_shallow": ("dx",)}


def b12_compare(name: str, got, ref, dtype: str, case: str,
                real_a11: bool = False) -> dict:
    """{"<entry point> <output> <case>": (err, tol, max_abs_err)} of one
    entry point's outputs against its plain version's. err is max|got −
    ref| / max|ref| with the tolerances: Gram sums 1e-3 (fp32 sums of up
    to 131072 products in two orders, as gram_fwd); activations, pool2 and
    dp1 1e-5 in fp32 and two bf16 ulps at max|ref| in bf16 (a rounding on
    the other side, which can move the next layer's rounding once more);
    dx 1e-5 in fp32, 1e-2 in bf16 (dz12 and dz11 are rounded to bf16 on
    the way). With `real_a11` (dx from the forward's a11, the deep
    backward's dp1 and the real conv1_2 weights) err is ‖got − ref‖₂ /
    ‖ref‖₂ instead, within 2e-3: both versions recompute conv1_2 in fp32 in
    their own orders, and where a value sits within that rounding of 0
    (relu′) or of its window's max, they send a dp1 value (up to ~1e4
    here) to different pixels."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    fp32 = dtype == "float32"
    out = {}
    for what, g, r in zip(B12_OUTS[name], got, ref):
        err, rel = rel_err(g, r)
        if what[0] == "g":
            tol = 1e-3
        elif what == "dx" and real_a11:
            what += " (forward's a11, real weights, rel L2)"
            rel = float(torch.linalg.vector_norm(g.float() - r.float())
                        / torch.linalg.vector_norm(r.float()))
            tol = 2e-3
        elif what == "dx":
            tol = 1e-5 if fp32 else 1e-2
        else:
            tol = 1e-5 if fp32 else 2 * out_tol(r, dtype)
        out[f"{name} {what} {case}"] = (rel, tol, err)
    return out


def check_block12_case(h, w, k, dtype, pooling, ties, dev, gen, params):
    """The four block12 entry points against their plain versions at one
    shape, the shallow backward twice: on inputs where both versions
    recompute conv1_2 exactly, and on the forward's a11 with the real
    weights. Returns `b12_compare`'s entries."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    cdt = getattr(torch, dtype)
    kw = dict(pooling=pooling, compute_dtype=dtype)
    case = f"{h}x{w} K={k} {dtype} {pooling}" + (" ties" if ties else "")
    wts = b12.pack_weights(params, dtype)
    x, m1, m2 = b12_forward_input(h, w, k, dev, gen, ties)
    got = b12.block12_fwd_res(x, m1, m2, wts, **kw)
    ref = b12.block12_fwd_plain(x, m1, m2, wts, pooling, dtype, True)
    out = b12_compare("block12_fwd_res", got, ref, dtype, case)
    out.update(b12_compare("block12_fwd", b12.block12_fwd(x, m1, m2, wts, **kw),
                           ref[:3], dtype, case))
    _, _, _, a11, a21, a22 = got
    dg2 = torch.randn((k, 128, 128), generator=gen, device=dev)
    dp2 = torch.randn((128, h // 4, w // 4), generator=gen,
                      device=dev).to(cdt)
    s2 = b12.symmetrize(dg2, dtype)
    dp1 = b12.block12_bwd_deep(a21, a22, dp2, m2, s2, wts, **kw)
    out.update(b12_compare(
        "block12_bwd_deep", dp1,
        b12.block12_bwd_deep_plain(a21, a22, dp2, m2, s2, wts, pooling, dtype),
        dtype, case))
    a11s, dp1s, wts_s, dg1 = b12_shallow_input(h, w, k, params, dtype, dev,
                                               gen)
    s1 = b12.symmetrize(dg1, dtype)
    out.update(b12_compare(
        "block12_bwd_shallow",
        b12.block12_bwd_shallow(a11s, dp1s, m1, s1, wts_s, **kw),
        b12.block12_bwd_shallow_plain(a11s, dp1s, m1, s1, wts_s, pooling,
                                      dtype), dtype, case))
    out.update(b12_compare(
        "block12_bwd_shallow",
        b12.block12_bwd_shallow(a11, dp1, m1, s1, wts, **kw),
        b12.block12_bwd_shallow_plain(a11, dp1, m1, s1, wts, pooling, dtype),
        dtype, case, real_a11=True))
    torch.cuda.synchronize()
    return out


def check_gram_dz(dev, gen):
    """The backwards' bf16 Gram cotangent stage alone (`block12_gram_dz`:
    the wgmma body with the conv-term and relu′ epilogue on the rows that
    reach an own output row) against `gram_dz_plain`, the stage the plain
    backwards call, on those rows, within `out_tol` (one rounding of fp32
    sums taken in two orders); its plan (`dpst_block12_df_plan`) equal to
    `block12_pallas.gram_dz_plan`. At the two group shapes of the 4096²
    step: its device time in turns with torch.matmul(s_matrix(S), W), W the
    pre-weighted (K·C, P) operand of the same pixels, a yardstick that does
    less work (no weighting, no conv term, no relu′)."""
    import ctypes
    from dpst_tpu_torch.ops import block12_pallas as b12
    from dpst_tpu_torch.ops import gram_stream as gs
    from dpst_tpu_torch.ops import kernels
    lib = kernels.library()
    cdt = torch.bfloat16
    rows, errs = [], {}
    for stage, c, nb, tb, w, k, timed in GRAM_DZ_CASES:
        r = (tb + 2 * b12.HALO) // (1 if stage == "shallow" else 2)
        lo, hi = b12.dz_rows(stage, tb)
        plan = (ctypes.c_int * 7)()
        lib.dpst_block12_df_plan(c, nb, r, w, lo, hi, plan)
        want = b12.gram_dz_plan(c, nb, r, w, (lo, hi))
        if tuple(plan) != want:
            fail("kernels", f"block12 Gram cotangent plan at {stage} {nb}x{r}"
                 f"x{w}: the kernel's {tuple(plan)}, gram_dz_plan's {want}")
        n = nb * r
        f = torch.randn((c, n, w), generator=gen,
                        device=dev).clamp_min(0).to(cdt)
        msq = (torch.rand((k, n, w), generator=gen, device=dev) ** 2).to(cdt)
        s = b12.symmetrize(torch.randn((k, c, c), generator=gen, device=dev),
                           "bfloat16")
        t = torch.randn((c, n, w), generator=gen, device=dev)

        def own(x):
            return x.reshape(x.shape[0], nb, r, w)[:, :, lo:hi]

        def kernel():
            return b12.block12_gram_dz(f, msq, s, t, band_rows=r,
                                       rows=(lo, hi))

        def plain():
            return b12.gram_dz_plain(f, msq, s, t, cdt)

        got, ref = own(kernel()), own(plain())
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        tol = out_tol(ref, "bfloat16")
        case = f"{stage} C={c} {nb}x{r}x{w} rows {lo}..{hi} K={k}"
        errs[case] = (rel, tol, err)
        del got, ref
        if not timed:
            continue
        px = nb * (hi - lo) * w
        fw = own((msq[:, None] * f[None]).reshape(k * c, n, w))
        fw = fw.reshape(k * c, px).contiguous()
        a = gs.s_matrix(s).contiguous()
        nbytes = px * (c * 2 + k * 2 + c * 4 + c * 2) + k * c * c * 2
        ops = 2.0 * k * c * c * px
        b, by = bound_ms(nbytes, ops, "bfloat16")
        row = {"phase": "kernel", "name": "block12_gram_dz", "stage": stage,
               "shape": [c, nb, r, w], "rows": [lo, hi], "K": k,
               "dtype": "bfloat16", "in_step": False, "max_abs_err": err,
               "rel_err": rel, "tol_rel": tol,
               **in_turns(kernel, lambda: torch.matmul(a, fw)),
               "plain_ms": cuda_ms(plain, warmup=1, iters=3),
               "bound_ms": b, "bound_by": by, "gflop": ops / 1e9,
               "gbytes": nbytes / 1e9,
               "library_call": "yardstick: torch.matmul(s_matrix(S), W), W "
                               "the pre-weighted (K·C, P) operand: no "
                               "weighting, conv term or relu′, less work"}
        emit(row)
        rows.append(row)
        del fw, a
        torch.cuda.empty_cache()
    emit({"phase": "kernel_gram_dz", "rel_err_tol_abs_err": errs})
    bad = [name for name, (e, tol, _) in errs.items() if not e <= tol]
    if bad:
        fail("kernels", "block12 Gram cotangent beyond tolerance: "
             + ", ".join(bad))
    return rows


def check_scratch_layout(lib) -> None:
    """The scratch each block12 entry point takes (csrc/block12.cu's count)
    equal to `block12_pallas.scratch_bytes`, the layout the CPU tests hold,
    at every B12_CASES geometry and at the 4096² step, in the bands
    `band_rows` picks and in bands of 32 rows."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    from dpst_tpu_torch.ops import kernels
    geoms = {(h, w, k, dtype) for h, w, k, dtype, *_ in B12_CASES}
    geoms.add((B12_SIZE, B12_SIZE, K, "bfloat16"))
    for h, w, k, dtype in sorted(geoms):
        for tb in sorted({b12.band_rows(h, w), 32}):
            group = b12.group_bands(h, w, tb)
            for which in range(3):
                got = lib.dpst_block12_scratch_bytes(
                    which, k, h, w, group, tb,
                    kernels.DTYPE_CODES[getattr(torch, dtype)])
                want = b12.scratch_bytes(which, k, h, w, group, dtype, tb)
                if got != want:
                    fail("kernels", f"block12 scratch {which} at {h}x{w} "
                         f"K={k} {dtype}, bands of {tb}: the kernel counts "
                         f"{got}, scratch_bytes {want}")


def stage_ms(fn) -> dict:
    """Device ms of one call of fn by kernel group (`kernel_group`;
    torch.profiler, after a warm-up call), largest first."""
    fn()
    torch.cuda.synchronize()
    groups: dict[str, float] = {}
    for name, us in device_events(fn, 1, bool):
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def timed_once(fn):
    """(fn(), the device ms of that one call), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def b12_bands_of(rows: int):
    """The block12 entry points, and the plain versions they fall back to,
    in bands of `rows` rows whatever the shape (both read
    `block12_pallas.band_rows`)."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    pick = b12.band_rows
    b12.band_rows = lambda h, w: rows
    try:
        yield
    finally:
        b12.band_rows = pick


def b12_step_calls(params: dict, dev, gen) -> tuple[dict, dict]:
    """The four block12 entry points at config6's step shape (4096², K =
    4, bf16, max pooling) on drawn inputs: {name: (kernel, plain)}, and the
    dict the backwards read their inputs from, which the caller fills:
    "a21_a22" and "a11" from the forward, "dp1" from the deep backward."""
    from dpst_tpu_torch.ops import block12_pallas as b12
    h = w = B12_SIZE
    k, dtype, pooling = K, "bfloat16", "max"
    cdt = torch.bfloat16
    kw = dict(pooling=pooling, compute_dtype=dtype)
    wts = b12.pack_weights(params, dtype)
    x, m1, m2 = b12_forward_input(h, w, k, dev, gen)
    dp2 = torch.randn((128, h // 4, w // 4), generator=gen,
                      device=dev).to(cdt)
    s1 = b12.symmetrize(torch.randn((k, 64, 64), generator=gen, device=dev),
                        dtype)
    s2 = b12.symmetrize(torch.randn((k, 128, 128), generator=gen,
                                    device=dev), dtype)
    res = {}
    calls = {
        "block12_fwd": (lambda: b12.block12_fwd(x, m1, m2, wts, **kw),
                        lambda: b12.block12_fwd_plain(
                            x, m1, m2, wts, pooling, dtype, False)),
        "block12_fwd_res": (lambda: b12.block12_fwd_res(x, m1, m2, wts, **kw),
                            lambda: b12.block12_fwd_plain(
                                x, m1, m2, wts, pooling, dtype, True)),
        "block12_bwd_deep": (lambda: b12.block12_bwd_deep(
            *res["a21_a22"], dp2, m2, s2, wts, **kw),
            lambda: b12.block12_bwd_deep_plain(
                *res["a21_a22"], dp2, m2, s2, wts, pooling, dtype)),
        "block12_bwd_shallow": (lambda: b12.block12_bwd_shallow(
            res["a11"], res["dp1"], m1, s1, wts, **kw),
            lambda: b12.block12_bwd_shallow_plain(
                res["a11"], res["dp1"], m1, s1, wts, pooling, dtype)),
    }
    return calls, res


def b12_heights_equal(calls: dict, heights) -> dict:
    """{"<entry point> <output> <rows> rows": (bit-equal, max |diff|)} of
    each kernel of `calls` ({name: (kernel, plain)}, `b12_step_calls`') in
    bands of each of `heights` rows against the same kernel in bands of 32
    rows, on the same inputs."""
    def outs(fn):
        got = fn()
        return got if isinstance(got, tuple) else (got,)
    with b12_bands_of(32):
        ref = {name: outs(kernel) for name, (kernel, _) in calls.items()}
    equal = {}
    for rows in heights:
        with b12_bands_of(rows):
            for name, (kernel, _) in calls.items():
                for what, g, r in zip(B12_OUTS[name], outs(kernel),
                                      ref[name]):
                    equal[f"{name} {what} {rows} rows"] = (
                        torch.equal(g, r),
                        float((g.float() - r.float()).abs().max()))
    del ref
    torch.cuda.empty_cache()
    return equal


def check_block12(dev, gen):
    """The block12 entry points against their plain versions at B12_CASES
    (one of which spans more than one group of bands, and one stacks
    several bands in a group), then at the 4096² step shape of config6 (K =
    4, bf16, max pooling): each output against the plain version's and bit
    for bit against the same kernel in bands of 32 rows, and each entry
    point's kernel time, its device time by stage, plain time, bound and
    cuDNN yardstick."""
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import block12_pallas as b12
    from dpst_tpu_torch.ops import kernels
    if not any(h // b12.band_rows(h, w) > b12.group_bands(h, w)
               for h, w, *_ in B12_CASES):
        fail("kernels", "no block12 case spans two groups of bands")
    if not any(b12.group_bands(h, w) > 1 for h, w, *_ in B12_CASES):
        fail("kernels", "no block12 case stacks two bands in a group")
    check_scratch_layout(kernels.library())
    params = vgg.init_params(SEED, device=dev)
    errs = {}
    for h, w, k, dtype, pooling, ties in B12_CASES:
        errs.update(check_block12_case(h, w, k, dtype, pooling, ties, dev,
                                       gen, params))
        torch.cuda.empty_cache()

    # the step shape: outputs held to the plain versions' (timed once),
    # then to the same kernels in bands of 32 rows, then the kernels timed
    h = w = B12_SIZE
    k, dtype, pooling = K, "bfloat16", "max"
    case = f"{h}x{w} K={k} {dtype} {pooling}"
    cdt = torch.bfloat16
    calls, res = b12_step_calls(params, dev, gen)
    plain_ms = {}
    for name, (kernel, plain) in calls.items():
        ref, plain_ms[name] = timed_once(plain)
        got = kernel()
        errs.update(b12_compare(name, got, ref, dtype, case,
                                real_a11=name == "block12_bwd_shallow"))
        if name == "block12_fwd_res":
            res["a11"], res["a21_a22"] = got[3], got[4:]
        elif name == "block12_bwd_deep":
            res["dp1"] = got
        del ref
        torch.cuda.empty_cache()
    emit({"phase": "kernel_block12", "rel_err_tol_abs_err": errs})
    bad = [name for name, (e, tol, _) in errs.items() if not e <= tol]
    if bad:
        fail("kernels", "block12 beyond tolerance: " + ", ".join(bad))
    tb = b12.band_rows(h, w)
    equal = b12_heights_equal(calls, (tb,))
    emit({"phase": "kernel_block12_band_rows", "band_rows": tb,
          "equal_max_abs_diff_to_32_rows": equal})
    bad = [name for name, (same, _) in equal.items() if not same]
    if bad:
        fail("kernels", f"block12 in bands of {tb} rows differs from "
             "bands of 32: " + ", ".join(bad))

    work = b12_work(h, w, k, 2)
    copies = b12_copy_bytes(h, w, k, 2)
    library = b12_cudnn(h, w, params, cdt)
    rows = []
    for name, (kernel, plain) in calls.items():
        nbytes, ops = work[name]
        bnd, by = bound_ms(nbytes, ops, dtype)
        case_errs = [v for n, v in errs.items()
                     if n.startswith(name + " ") and "bfloat16" in n]
        ms = cuda_ms(kernel, warmup=1, iters=3)
        row = {"phase": "kernel", "name": name, "shape": [h, w], "K": k,
               "dtype": dtype, "pooling": pooling,
               "band_rows": b12.last_band_rows,
               "rows_walked": b12.last_rows_walked,
               "max_abs_err": max(v[2] for v in case_errs), "ms": ms,
               "device_ms_by_stage": stage_ms(kernel),
               "copies_gbytes": copies[name] / 1e9,
               "copies_bound_ms": copies[name] / peaks.HBM_BYTES_PER_S
               * 1e3,
               "plain_ms": plain_ms[name],
               "bound_ms": bnd, "bound_by": by, "gflop": ops / 1e9,
               "gbytes": nbytes / 1e9, "library_ms": library[name],
               "library_call": B12_YARDSTICK[name]}
        emit(row)
        rows.append(row)
    del calls, res
    torch.cuda.empty_cache()
    return rows


def check_block12_batch(dev, gen):
    """The block12 entry points on a batch of B distinct pairs, one launch
    of each for the batch, at B12_BATCH_CASES (one with groups of bands
    that run from one pair into the next: the check fails if none has
    one): each pair's outputs bit-equal to its one-pair launch, bf16 and
    fp32. The timed cases give "<entry point> B=<B>" rows: device time by
    events in turns with the B one-pair launches (`looped_ms`), the plain
    version's time on the batch (once), the bound of B pairs' work, and
    cuDNN's yardstick on a batch of B."""
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import block12_pallas as b12
    spans = [(b, h, w) for b, h, w, *_ in B12_BATCH_CASES
             if any(g[0][0] != g[-1][0] for g in b12.unit_groups(b, h, w))]
    if not spans:
        fail("kernels", "no batched block12 case has a group of bands that "
             "spans two pairs")
    params = vgg.init_params(SEED, device=dev)
    rows, equal = [], {}
    for b, h, w, dtype, timed in B12_BATCH_CASES:
        cdt = getattr(torch, dtype)
        kw = dict(pooling="max", compute_dtype=dtype)
        wts = b12.pack_weights(params, dtype)
        x, m1, m2 = (torch.stack(t) for t in zip(
            *(b12_forward_input(h, w, K, dev, gen) for _ in range(b))))
        dp2 = torch.randn((b, 128, h // 4, w // 4), generator=gen,
                          device=dev).to(cdt)
        s1 = b12.symmetrize(torch.randn((b, K, 64, 64), generator=gen,
                                        device=dev), dtype)
        s2 = b12.symmetrize(torch.randn((b, K, 128, 128), generator=gen,
                                        device=dev), dtype)
        res = {}
        res["fwd"] = b12.block12_fwd_res(x, m1, m2, wts, **kw)
        a11, a21, a22 = res["fwd"][3:]
        res["dp1"] = b12.block12_bwd_deep(a21, a22, dp2, m2, s2, wts, **kw)
        calls = {
            "block12_fwd": (
                lambda: b12.block12_fwd(x, m1, m2, wts, **kw),
                lambda i: b12.block12_fwd(x[i], m1[i], m2[i], wts, **kw),
                lambda: b12.block12_fwd_plain(x, m1, m2, wts, "max", dtype,
                                              False)),
            "block12_fwd_res": (
                lambda: b12.block12_fwd_res(x, m1, m2, wts, **kw),
                lambda i: b12.block12_fwd_res(x[i], m1[i], m2[i], wts, **kw),
                lambda: b12.block12_fwd_plain(x, m1, m2, wts, "max", dtype,
                                              True)),
            "block12_bwd_deep": (
                lambda: b12.block12_bwd_deep(a21, a22, dp2, m2, s2, wts,
                                             **kw),
                lambda i: b12.block12_bwd_deep(a21[i], a22[i], dp2[i], m2[i],
                                               s2[i], wts, **kw),
                lambda: b12.block12_bwd_deep_plain(a21, a22, dp2, m2, s2,
                                                   wts, "max", dtype)),
            "block12_bwd_shallow": (
                lambda: b12.block12_bwd_shallow(a11, res["dp1"], m1, s1,
                                                wts, **kw),
                lambda i: b12.block12_bwd_shallow(a11[i], res["dp1"][i],
                                                  m1[i], s1[i], wts, **kw),
                lambda: b12.block12_bwd_shallow_plain(
                    a11, res["dp1"], m1, s1, wts, "max", dtype)),
        }
        case = f"B={b} {h}x{w} K={K} {dtype}"
        work = b12_work(h, w, K, cdt.itemsize)
        library = b12_cudnn(h, w, params, cdt, b) if timed else {}
        for name, (batch, one, plain) in calls.items():
            done = {"block12_fwd_res": "fwd", "block12_bwd_deep": "dp1"}
            got = res[done[name]] if name in done else batch()
            got = got if isinstance(got, tuple) else (got,)
            diff = 0.0
            for i in range(b):
                alone = one(i)
                alone = alone if isinstance(alone, tuple) else (alone,)
                equal[f"{name} {case} pair {i}"] = all(
                    torch.equal(g[i], a) for g, a in zip(got, alone))
                diff = max([diff] + [float((g[i].float() - a.float()).abs()
                                           .max())
                                     for g, a in zip(got, alone)])
            del got
            torch.cuda.synchronize()
            if not timed:
                continue

            def looped(one=one):
                return [one(i) for i in range(b)]

            k1, l1, l2, k2 = (cuda_ms(batch, warmup=1, iters=3),
                              cuda_ms(looped, warmup=1, iters=3),
                              cuda_ms(looped, warmup=1, iters=3),
                              cuda_ms(batch, warmup=1, iters=3))
            _, plain_ms = timed_once(plain)
            nbytes, ops = work[name]
            bnd, by = bound_ms(b * nbytes, b * ops, dtype)
            row = {"phase": "kernel", "name": name, "B": b, "shape": [h, w],
                   "K": K, "dtype": dtype, "pooling": "max",
                   "groups_span_pairs": (b, h, w) in spans,
                   "max_abs_err": diff, "ms": (k1 + k2) / 2,
                   "looped_ms": (l1 + l2) / 2, "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by, "gflop": b * ops / 1e9,
                   "gbytes": b * nbytes / 1e9, "library_ms": library[name],
                   "library_call": B12_YARDSTICK[name] + f", a batch of {b}"}
            emit(row)
            rows.append(row)
        del x, m1, m2, dp2, s1, s2, res, a11, a21, a22
        torch.cuda.empty_cache()
    emit({"phase": "kernel_block12_batch", "bit_equal_to_one_pair": equal,
          "cases_with_groups_across_pairs": spans})
    bad = [name for name, ok in equal.items() if not ok]
    if bad:
        fail("kernels", "batched block12 differs from one-pair launches: "
             + ", ".join(bad))
    return rows


def precompute_seconds(dev, cfg, params, *arrays) -> float:
    """`prepare_constants` alone, through the public entry point, on
    (content, style, content masks, style masks): warm, then timed."""
    import dpst_tpu_torch
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    dpst_tpu_torch.prepare_constants(*args, cfg, params)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dpst_tpu_torch.prepare_constants(*args, cfg, params)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_single_scale(dev, gen, cfg, label: str, check_launches) -> dict:
    """One single-scale main path at SIZE² on a seeded pair with the four
    band masks: `prepare_constants` alone (warm, timed), then `stylize`
    with the launch counters reset just before and read just after (and
    handed to `check_launches(launches)`, which returns the failures);
    checks the losses and the output, a bit-identical rerun of RERUN_ITERS
    steps, and profiles ten steps."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels

    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = smooth_image(gen, dev, SIZE).cpu().numpy()
    cmask, smask = band_masks(K, SIZE, 0, 0), band_masks(K, SIZE, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)

    precompute_s = precompute_seconds(dev, cfg, params, content, style,
                                      cmask, smask)

    marks = {}

    def callback(step, image, hist):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()

    def run(cfg, callback=None):
        return dpst_tpu_torch.stylize(
            content, style, cfg, content_masks=cmask, style_masks=smask,
            vgg_params=params, callback=callback, return_history=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, hist = run(cfg, callback)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    half = ITERS // 2
    loop_its = half / (marks[ITERS] - marks[half])
    emit({"phase": "stylize", "path": label, "size": SIZE, "K": K,
          "iterations": ITERS, "compute_dtype": cfg.compute_dtype,
          "conv_impl": cfg.conv_impl, "gram_impl": cfg.gram_impl,
          "weights": weights_label(),
          "precompute_s": precompute_s, "loop_it_s": loop_its,
          "wall_s": wall_s, "first_row": hist[0].tolist(),
          "last_row": hist[-1].tolist(), "launches": launches,
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    bad = check_launches(launches)
    if bad:
        fail("stylize", f"{label}: " + "; ".join(bad))
    if not hist[-1, 0] < hist[0, 0]:
        fail("stylize", f"{label}: total loss did not fall: {hist[0, 0]} "
             f"-> {hist[-1, 0]}")
    if not hist[:, 3].min() >= -1.0:
        fail("stylize", f"{label}: photoreal term {hist[:, 3].min()} < -1")
    if not (out.shape == (SIZE, SIZE, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 255.0):
        fail("stylize", f"{label}: output not finite (512, 512, 3) in "
             "[0, 255]")
    if not np.isfinite(hist).all():
        fail("stylize", f"{label}: non-finite loss history")

    # the same config again, shorter: the rows must be bit-identical
    _, hist2 = run(dataclasses.replace(cfg, iterations=RERUN_ITERS))
    identical = bool(np.array_equal(hist2, hist[:RERUN_ITERS]))
    emit({"phase": "rerun", "path": label, "iterations": RERUN_ITERS,
          "bit_identical": identical})
    if not identical:
        fail("rerun", f"{label}: history of the rerun differs")
    emit_profile(label, 5, 10, run, cfg, 1e3 / loop_its)
    return launches


def run_main_path(dev, gen) -> dict:
    """The first main path: PRESETS["config3"] at 512² (cuDNN convs, the
    fused Gram route)."""
    import dpst_tpu_torch
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              iterations=ITERS,
                              intermediate_interval=ITERS // 2)

    def check(launches):
        need = {"lap_matvec": ITERS, "gram_fwd": 5 * ITERS,
                "gram_bwd": 5 * ITERS, "pool_bwd": 4 * ITERS,
                "bias_relu_fwd": 13 * ITERS, "bias_relu_bwd": 13 * ITERS}
        bad = [f"{name} launched {launches[name]} times, expected >= {lo}"
               for name, lo in need.items() if launches[name] < lo]
        bad += [f"{name} launched {launches[name]} times, expected 0"
                for name in ("conv3x3", "gram_wbwd") if launches[name]]
        return bad

    return run_single_scale(dev, gen, cfg, "config3 512²", check)


def pallas_route_launches(steps: int) -> dict:
    """What the config3 route with conv_impl="pallas", gram_impl="pallas"
    launches at 512², K = 4, precompute included. Per step: conv1_2 …
    conv5_1 forward and their input gradients (24 conv3x3); the style taps
    conv2_1 … conv5_1 on the Pallas Gram route (gram_fwd, gram_wbwd), and
    conv1_1 on the fused bias+ReLU pair (the route is no longer "fused",
    so a TPU's s2d Gram kernel takes it); one Laplacian matvec; four pool
    backwards; the bias+ReLU of all 13 convs each way. Precompute: 9 convs
    of the content (to conv4_2) and 12 of the style (to conv5_1) on
    conv3x3, the bias+ReLU of all 10 and 13, and the five style Grams on
    the fused route (gram_fwd)."""
    return {"conv3x3": 24 * steps + 9 + 12, "gram_fwd": 4 * steps + 5,
            "gram_wbwd": 4 * steps, "gram_relu_fwd": steps,
            "gram_relu_bwd": steps, "gram_bwd": 0, "lap_matvec": steps,
            "pool_bwd": 4 * steps, "bias_relu_fwd": 13 * steps + 10 + 13,
            "bias_relu_bwd": 13 * steps}


def run_pallas_route(dev, gen) -> dict:
    """The third main path: PRESETS["config3"] with conv_impl="pallas" and
    gram_impl="pallas" at 512²; the counters must equal what the route
    implies."""
    import dpst_tpu_torch
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              conv_impl="pallas", gram_impl="pallas",
                              iterations=ITERS,
                              intermediate_interval=ITERS // 2)
    need = pallas_route_launches(ITERS)

    def check(launches):
        return [f"{name} launched {launches[name]} times, the route implies "
                f"{n}" for name, n in need.items() if launches[name] != n]

    return run_single_scale(dev, gen, cfg, "config3 pallas route 512²",
                            check)


def profile_loop(run, cfg, first: int, steps: int):
    """Run `run(cfg, callback)` for first + steps Adam steps and profile
    steps first+1 … first+steps by kernel group with torch.profiler; the
    peak memory is reset at step `first`. Returns (device ms per step by
    group, busy ms per step, step ms with the profiler on, peak GB of the
    profiled steps, the run's history)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def callback(step, image, hist):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()
        if step == first:
            torch.cuda.reset_peak_memory_stats()
            prof.start()
        elif step == first + steps:
            prof.stop()

    _, hist = run(dataclasses.replace(
        cfg, iterations=first + steps,
        intermediate_interval=math.gcd(first, steps)), callback)
    peak = torch.cuda.max_memory_allocated() / 1e9
    groups: dict[str, float] = {}
    for ev in prof.events():
        if on_device(ev):
            g = kernel_group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.time_range.elapsed_us() / 1e3
    if not groups:
        fail("profile", "torch.profiler recorded no device time")
    per_step = {g: t / steps for g, t in sorted(groups.items(),
                                                key=lambda kv: -kv[1])}
    step_ms = (marks[first + steps] - marks[first]) * 1e3 / steps
    return per_step, sum(per_step.values()), step_ms, peak, hist


def emit_profile(label: str, first: int, steps: int, run, cfg,
                 step_ms: float) -> None:
    """`profile_loop`'s groups and the device's busy share against the
    unprofiled step time `step_ms`."""
    per_step, busy, _, _, _ = profile_loop(run, cfg, first, steps)
    emit({"phase": "profile", "path": label, "steps": steps,
          "device_ms_per_step": per_step, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms})


def stripe_masks(k: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """k content masks in horizontal stripes, k style masks in vertical
    ones."""
    cm = np.zeros((k, size, size), np.float32)
    sm = np.zeros((k, size, size), np.float32)
    for i in range(k):
        cm[i, i * size // k:(i + 1) * size // k] = 1
        sm[i, :, i * size // k:(i + 1) * size // k] = 1
    return cm, sm


def run_small_reference(gen, cfg, label: str, size: int = 64,
                        k: int = 3) -> dict:
    """A small fp32 run of `cfg` (64² unless `size`) on the card against the
    same run on the CPU, where every kernel wrapper takes its plain
    version. Returns the launch counts of the card's run."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    content = smooth_image(gen, gen.device, size).cpu().numpy()
    style = smooth_image(gen, gen.device, size).cpu().numpy()
    cm, sm = stripe_masks(k, size)
    params = vgg.init_params(SEED)
    hists = {}
    for where in ("cuda", "cpu"):
        kernels.reset_launches()
        _, hists[where] = dpst_tpu_torch.stylize(
            content, style, cfg, content_masks=cm, style_masks=sm,
            vgg_params=params, return_history=True, device=where)
        if where == "cuda":
            launches = dict(kernels.LAUNCHES)
    rel = np.abs(hists["cuda"] - hists["cpu"]) / np.maximum(
        np.abs(hists["cpu"]).max(axis=0), 1e-30)
    worst = float(rel.max())
    tol = 1e-3
    emit({"phase": "reference", "path": label, "size": size, "K": k,
          "iterations": len(hists["cpu"]), "compute_dtype": "float32",
          "max_rel_err_vs_cpu": worst, "tol_rel": tol,
          "card_launches": launches})
    if not worst <= tol:
        fail("reference", f"{label}: card vs CPU history rel err {worst} "
             f"> {tol}")
    return launches


def run_multiscale(dev, gen) -> dict:
    """The config4 path: 256² → 512² → 1024² with 100 Adam steps a stage."""
    import dpst_tpu_torch
    from dpst_tpu_torch import api
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels

    content = smooth_image(gen, dev, MS_SIZE).cpu().numpy()
    style = smooth_image(gen, dev, MS_SIZE).cpu().numpy()
    cmask, smask = band_masks(K, MS_SIZE, 0, 0), band_masks(K, MS_SIZE, 1, 0)
    half = MS_ITERS[0] // 2
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config4"],
                              scale_iters=MS_ITERS,
                              intermediate_interval=half)
    stages = api._scale_schedule(cfg, (MS_SIZE, MS_SIZE))
    if [st[:2] for st in stages] != [(MS_SIZE // d,) * 2 for d in (4, 2, 1)]:
        fail("multiscale", f"unexpected schedule {stages}")
    params = vgg.get_params(seed=SEED, device=dev)

    # each stage's precompute alone (warm), through the stage function
    full = [torch.from_numpy(a).to(dev) for a in (content, style, cmask,
                                                  smask)]
    precompute_s = []
    for h, w, _ in stages:
        api._prepare_stage(*full, params, (h, w), cfg)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api._prepare_stage(*full, params, (h, w), cfg)
        torch.cuda.synchronize()
        precompute_s.append(time.perf_counter() - t0)
    del full

    marks = {}

    def callback(step, image, hist):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()

    def run(cfg, callback=None):
        return dpst_tpu_torch.stylize(
            content, style, cfg, content_masks=cmask, style_masks=smask,
            vgg_params=params, callback=callback, return_history=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, hist = run(cfg, callback)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loop_its, ends, start = [], [], 0
    for _, _, n in stages:
        loop_its.append(half / (marks[start + n] - marks[start + half]))
        ends.append((start, start + n))
        start += n
    emit({"phase": "multiscale", "size": MS_SIZE, "K": K,
          "stages": [list(st) for st in stages],
          "compute_dtype": cfg.compute_dtype,
          "weights": weights_label(),
          "precompute_s_per_stage": precompute_s,
          "loop_it_s_per_stage": loop_its, "wall_s": wall_s,
          "first_rows": [hist[a].tolist() for a, _ in ends],
          "last_rows": [hist[b - 1].tolist() for _, b in ends],
          "launches": launches, "max_memory_gb": peak_gb})
    # what the schedule implies: every step launches the Laplacian once
    # and the four pools once each; the style taps' Grams (5 per step, and
    # 5 per stage's precompute) take gram_fwd/gram_bwd, except conv1_1 in
    # the loop of the 1024² stage, which takes the fused pair; the convs
    # stay on cuDNN and no Gram takes the weighted-after backward
    steps = sum(MS_ITERS)
    fused = MS_ITERS[2]
    need = {"lap_matvec": steps, "pool_bwd": 4 * steps,
            "gram_fwd": 5 * len(stages) + 5 * steps - fused,
            "gram_bwd": 5 * steps - fused,
            "gram_relu_fwd": fused, "gram_relu_bwd": fused,
            "conv3x3": 0, "gram_wbwd": 0}
    for name, n in need.items():
        if launches[name] != n:
            fail("multiscale", f"{name} launched {launches[name]} times, "
                 f"the schedule implies {n}")
    for a, b in ends:
        if not hist[b - 1, 0] < hist[a, 0]:
            fail("multiscale", f"total loss did not fall in steps {a}-{b}: "
                 f"{hist[a, 0]} -> {hist[b - 1, 0]}")
    if not hist[:, 3].min() >= -1.0:
        fail("multiscale", f"photoreal term {hist[:, 3].min()} < -1")
    if not (out.shape == (MS_SIZE, MS_SIZE, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 255.0):
        fail("multiscale", "output not finite (1024, 1024, 3) in [0, 255]")
    if not np.isfinite(hist).all():
        fail("multiscale", "non-finite loss history")

    # the 1024² stage alone: config4 at its native size, one stage
    stage3 = dataclasses.replace(cfg, scales=(), scale_iters=())
    emit_profile("config4 1024² stage", 5, 10, run, stage3, 1e3 / loop_its[2])

    # a short config4 run twice: the rows must be bit-identical
    short = dataclasses.replace(cfg, scale_iters=(3, 3, 3))
    _, h1 = run(short)
    _, h2 = run(short)
    identical = bool(np.array_equal(h1, h2))
    emit({"phase": "rerun", "path": "config4", "scale_iters": [3, 3, 3],
          "bit_identical": identical})
    if not identical:
        fail("rerun", "config4: history of the rerun differs")
    return launches


def stream12_launches(steps: int) -> dict:
    """What config6 launches at 4096², K = 4, precompute included. Per
    step: the three block12 entry points once each (blocks 1-2 with the
    conv1_1 and conv2_1 Grams); the tail's style taps conv3_1 (2^30
    elements of the weighted block, past 2^29: "stream", so gram_fwd +
    gram_wbwd), conv4_1 and conv5_1 (fused: gram_fwd + gram_bwd); pool3
    and pool4 backward; one Laplacian matvec; the tail's nine bias+ReLU
    each way (conv3_1 … conv5_1). Precompute: the five style Grams
    (gram_fwd) and the bias+ReLU of the content's 10 convs and the
    style's 13 on the standard path. Nothing else."""
    return {"block12_fwd_res": steps, "block12_bwd_deep": steps,
            "block12_bwd_shallow": steps, "block12_fwd": 0,
            "gram_fwd": 5 + 3 * steps, "gram_wbwd": steps,
            "gram_bwd": 2 * steps, "pool_bwd": 2 * steps,
            "lap_matvec": steps, "gram_relu_fwd": 0, "gram_relu_bwd": 0,
            "conv3x3": 0, "bias_relu_fwd": 23 + 9 * steps,
            "bias_relu_bwd": 9 * steps}


def run_stream12(dev, gen) -> dict:
    """The fourth main path: config6 (bench.py), PRESETS["config3"] with
    stream12_impl="pallas" at 4096² (stream12=-1: 32 strips by the TPU's
    rule; blocks 1-2 on the block12 kernels), K = 4 band masks, bf16, a
    smooth content image and a textured style image, B12_ITERS Adam steps;
    counters reset just before and read just after, held to what the route
    implies; the loop's peak memory (reset after the first step). Then its
    profile, the standard path (stream12=0) at the same size for
    1 + B12_STD_ITERS steps, profiled after the first, with its loop peak
    and its history rows held to the route's, and a bit-identical rerun at
    1024² with stream12=8. Returns (the launches, the route's ms a step
    and loop peak GB)."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import block12_pallas as b12
    from dpst_tpu_torch.ops import kernels

    size = B12_SIZE
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              stream12_impl="pallas", iterations=B12_ITERS,
                              intermediate_interval=1)
    if optimize.block12_route(cfg, (size, size, 3)) != "kernel":
        fail("stream12", "config6 does not take the block12 kernels")
    content = smooth_image(gen, dev, size).cpu().numpy()
    style = textured_image(gen, dev, size).cpu().numpy()
    cmask, smask = band_masks(K, size, 0, 0), band_masks(K, size, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)

    args = [torch.from_numpy(a).to(dev) for a in (content, style, cmask,
                                                  smask)]
    dpst_tpu_torch.prepare_constants(*args, cfg, params)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dpst_tpu_torch.prepare_constants(*args, cfg, params)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    del args
    torch.cuda.empty_cache()

    def run(cfg, callback=None, content=content, style=style, cmask=cmask,
            smask=smask):
        return dpst_tpu_torch.stylize(
            content, style, cfg, content_masks=cmask, style_masks=smask,
            vgg_params=params, callback=callback, return_history=True)

    marks = {}

    def callback(step, image, hist):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()
        if step == 1:
            torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    out, hist = run(cfg, callback)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    half = B12_ITERS // 2
    loop_its = (B12_ITERS - half) / (marks[B12_ITERS] - marks[half])
    need = stream12_launches(B12_ITERS)
    emit({"phase": "stream12", "path": "config6 4096²", "size": size, "K": K,
          "iterations": B12_ITERS, "compute_dtype": cfg.compute_dtype,
          "strips": vgg.stream12_strips(cfg.stream12, size, size),
          "weights": weights_label(),
          "precompute_s": precompute_s, "loop_it_s": loop_its,
          "wall_s": wall_s, "first_row": hist[0].tolist(),
          "last_row": hist[-1].tolist(), "launches": launches,
          "launches_implied": need, "loop_peak_gb": peak_gb,
          "block12_band_rows": b12.last_band_rows,
          "block12_rows_walked": b12.last_rows_walked})
    bad = [f"{name} launched {launches[name]} times, the route implies {n}"
           for name, n in need.items() if launches[name] != n]
    if bad:
        fail("stream12", "; ".join(bad))
    if not hist[-1, 0] < hist[0, 0]:
        fail("stream12", f"total loss did not fall: {hist[0, 0]} -> "
             f"{hist[-1, 0]}")
    if not hist[:, 3].min() >= -1.0:
        fail("stream12", f"photoreal term {hist[:, 3].min()} < -1")
    if not (out.shape == (size, size, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 255.0):
        fail("stream12", "output not finite (4096, 4096, 3) in [0, 255]")
    if not np.isfinite(hist).all():
        fail("stream12", "non-finite loss history")

    emit_profile("config6 4096² (stream12 route)", 2, 4, run, cfg,
                 1e3 / loop_its)

    std = dataclasses.replace(cfg, stream12=0)
    if optimize.block12_route(std, (size, size, 3)) != "standard":
        fail("stream12", "stream12=0 does not take the standard path")
    kernels.reset_launches()
    per_step_s, busy_s, step_ms_s, peak_s, hist_s = profile_loop(
        run, std, 1, B12_STD_ITERS)
    emit({"phase": "standard_4096", "path": "config3 4096² stream12=0",
          "steps": B12_STD_ITERS, "device_ms_per_step": per_step_s,
          "device_busy_ms_per_step": busy_s, "step_ms_profiled": step_ms_s,
          "loop_peak_gb": peak_s, "route_loop_peak_gb": peak_gb,
          "first_row": hist_s[0].tolist(),
          "route_first_row": hist[0].tolist(),
          "launches": dict(kernels.LAUNCHES)})
    if kernels.LAUNCHES["block12_fwd_res"]:
        fail("stream12", "the standard path launched block12 kernels")
    # the same loss on the same inputs: the route's first rows against the
    # standard path's, each column within 1e-2 of its largest value (bf16
    # convs, Grams and pools rounded at other points on the two paths)
    n = len(hist_s)
    dev_rows = np.abs(hist[:n] - hist_s) / np.maximum(
        np.abs(hist_s).max(axis=0), 1e-30)
    emit({"phase": "route_vs_standard", "rows": n,
          "max_rel_err_per_column": dev_rows.max(axis=0).tolist(),
          "tol_rel": 1e-2})
    if not dev_rows.max() <= 1e-2:
        fail("stream12", f"route and standard path differ: "
             f"{dev_rows.max(axis=0).tolist()}")
    if not peak_gb < peak_s:
        fail("stream12", f"the route's loop peak {peak_gb} GB is not below "
             f"the standard path's {peak_s} GB: the bands are not streaming")

    # a short run at 1024² with stream12=8, twice: bit-identical rows
    small = 1024
    c1 = smooth_image(gen, dev, small).cpu().numpy()
    s1 = smooth_image(gen, dev, small).cpu().numpy()
    m1, m2 = band_masks(K, small, 0, 0), band_masks(K, small, 1, 0)
    short = dataclasses.replace(cfg, stream12=8, iterations=3)
    if optimize.block12_route(short, (small, small, 3)) != "kernel":
        fail("rerun", "1024² with stream12=8 does not take the kernels")
    _, h1 = run(short, content=c1, style=s1, cmask=m1, smask=m2)
    _, h2 = run(short, content=c1, style=s1, cmask=m1, smask=m2)
    identical = bool(np.array_equal(h1, h2))
    emit({"phase": "rerun", "path": "stream12 route 1024²", "iterations": 3,
          "bit_identical": identical})
    if not identical:
        fail("rerun", "stream12 route: history of the rerun differs")
    return launches, {"step_ms": 1e3 / loop_its, "loop_peak_gb": peak_gb}


def run_stream12_batch(dev, gen, smi: str, one: dict) -> dict:
    """config6's route on a batch: `stylize_batch` of B12_BATCH distinct
    4096² pairs (K = 4 band masks drawn per pair, `batch_masks`),
    PRESETS["config3"] with stream12_impl="pallas", bf16, B12_BATCH_ITERS
    Adam steps. Counters reset just before and read just after, equal to
    one pair's run of the route (`stream12_launches`: each block12 entry
    point once a step for the batch, block12_fwd never); the loss falls
    for every pair, the output is finite in [0, 255]; a rerun bit for
    bit; each pair against its run alone through `stylize` (under the
    batch's resolved config) within BATCH_ROW0_TOL, BATCH_HIST_TOL and
    BATCH_PIXEL_TOL. Then the loop alone (after one step): ms a step and
    pair-it/s, its peak memory, device ms a step by group and the busy
    share, beside the one-pair route's `one` (run_stream12's)."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import batch as pb
    size, b, steps = B12_SIZE, B12_BATCH, B12_BATCH_ITERS
    label = f"config6 batch B={b} 4096²"
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              stream12_impl="pallas", iterations=steps)
    rcfg = pb.resolve_config(cfg)
    if optimize.block12_route(rcfg, (size, size, 3)) != "kernel":
        fail("stream12 batch", "config6's batch does not take the block12 "
             "kernels")
    contents = torch.stack([smooth_image(gen, dev, size)
                            for _ in range(b)]).cpu().numpy()
    styles = torch.stack([textured_image(gen, dev, size)
                          for _ in range(b)]).cpu().numpy()
    cm, sm = batch_masks(b, size)
    params = vgg.get_params(seed=SEED, device=dev)

    def run():
        return dpst_tpu_torch.stylize_batch(contents, styles, cm, sm, cfg,
                                            vgg_params=params)
    kernels.reset_launches()
    t0 = time.perf_counter()
    images, hist = run()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    images2, hist2 = run()
    identical = bool(np.array_equal(hist, hist2)
                     and np.array_equal(images, images2))
    del images2, hist2

    # the loop alone on the batch's constants
    pp = vgg.pack_params(params, rcfg.compute_dtype, rcfg.conv_impl)
    weights = optimize.LossWeights.from_config(rcfg)
    consts, cs, means = pb.prepare_batch_stage(
        *(torch.from_numpy(a).to(dev) for a in (contents, styles, cm, sm)),
        pp, (size, size), rcfg)
    img0 = optimize.init_image(rcfg, cs, means)
    pb.run_batch(img0, consts, weights, pp, rcfg, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pb.run_batch(img0, consts, weights, pp, rcfg, steps)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = loop_s * 1e3 / steps
    groups = profile_batch(
        lambda: pb.run_batch(img0, consts, weights, pp, rcfg, 2), 2)
    busy = sum(groups.values())
    del consts, cs, means, img0
    torch.cuda.empty_cache()

    alone = []
    for i in range(b):
        out_i, hist_i = dpst_tpu_torch.stylize(
            contents[i], styles[i], rcfg, content_masks=cm[i],
            style_masks=sm[i], vgg_params=params, return_history=True)
        d = np.abs(images[i] - out_i)
        rel = np.abs(hist[i] - hist_i) / np.maximum(
            np.abs(hist_i).max(axis=0), 1e-30)
        alone.append({"row0_rel": float(rel[0].max()),
                      "hist_rel": float(rel.max()),
                      "pixel_max": float(d.max()),
                      "pixel_mean": float(d.mean()),
                      "bit_equal": bool(np.array_equal(images[i], out_i))})
        del out_i
    need = stream12_launches(steps)
    emit({"phase": "stream12 batch", "path": label, "B": b, "size": size,
          "K": K, "iterations": steps, "compute_dtype": cfg.compute_dtype,
          "weights": weights_label(), "wall_s": wall_s,
          "step_ms": step_ms, "pair_it_s": b * steps / loop_s,
          "loop_peak_gb": peak_gb, "device_ms_per_step": groups,
          "device_busy_ms_per_step": busy, "device_busy_share": busy / step_ms,
          "one_pair_step_ms": one["step_ms"],
          "one_pair_loop_peak_gb": one["loop_peak_gb"],
          "launches": launches, "launches_implied": need,
          "first_rows": hist[:, 0].tolist(), "last_rows": hist[:, -1].tolist(),
          "vs_alone": alone, "row0_tol_rel": BATCH_ROW0_TOL,
          "hist_tol_rel": BATCH_HIST_TOL, "pixel_tol": BATCH_PIXEL_TOL,
          "rerun_bit_identical": identical, "nvidia_smi": smi})
    bad = [f"{name} launched {launches[name]} times, one pair's route "
           f"implies {n}" for name, n in need.items()
           if launches[name] != n]
    if not (hist[:, -1, 0] < hist[:, 0, 0]).all():
        bad.append("the total loss did not fall for every pair")
    if not hist[:, :, 3].min() >= -1.0:
        bad.append(f"photoreal term {hist[:, :, 3].min()} < -1")
    if not (images.shape == (b, size, size, 3) and np.isfinite(images).all()
            and images.min() >= 0.0 and images.max() <= 255.0):
        bad.append("output not finite (B, 4096, 4096, 3) in [0, 255]")
    for i, e in enumerate(alone):
        if not (e["row0_rel"] <= BATCH_ROW0_TOL
                and e["hist_rel"] <= BATCH_HIST_TOL
                and e["pixel_mean"] <= BATCH_PIXEL_TOL):
            bad.append(f"pair {i} against its run alone: {e}")
    if not identical:
        bad.append("the rerun is not bit-identical")
    if bad:
        fail("stream12 batch", f"{label}: " + "; ".join(bad))
    return launches


def run_small_batch_reference(gen, cfg, label: str, size: int,
                              b: int = 2) -> dict:
    """An fp32 `stylize_batch` of b distinct pairs (3 stripe masks drawn
    per pair, `batch_masks`) on the card, each pair against its one-pair
    `stylize` run on the card under the batch's resolved config: history
    rows within 1e-3 of each column's max, as `run_small_reference` holds
    card against CPU. Returns the batch's launch counts."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import batch as pb
    contents = torch.stack([smooth_image(gen, gen.device, size)
                            for _ in range(b)]).cpu().numpy()
    styles = torch.stack([smooth_image(gen, gen.device, size)
                          for _ in range(b)]).cpu().numpy()
    cm, sm = batch_masks(b, size, 3)
    params = vgg.init_params(SEED)
    kernels.reset_launches()
    _, hist = dpst_tpu_torch.stylize_batch(contents, styles, cm, sm, cfg,
                                           vgg_params=params)
    launches = dict(kernels.LAUNCHES)
    rcfg = pb.resolve_config(cfg)
    worst = 0.0
    for i in range(b):
        _, h_i = dpst_tpu_torch.stylize(
            contents[i], styles[i], rcfg, content_masks=cm[i],
            style_masks=sm[i], vgg_params=params, return_history=True)
        rel = np.abs(hist[i] - h_i) / np.maximum(np.abs(h_i).max(axis=0),
                                                 1e-30)
        worst = max(worst, float(rel.max()))
    tol = 1e-3
    emit({"phase": "reference", "path": f"{label} batch B={b}", "size": size,
          "K": 3, "iterations": hist.shape[1], "compute_dtype": "float32",
          "max_rel_err_vs_one_pair": worst, "tol_rel": tol,
          "card_launches": launches})
    if not worst <= tol:
        fail("reference", f"{label} batch B={b}: pairs vs their one-pair "
             f"runs, history rel err {worst} > {tol}")
    return launches


def lbfgs_launches(evals: int) -> dict:
    """What the L-BFGS path launches at 512², K = 4, for `evals`
    evaluations of the objective (each a forward and an input gradient:
    one Laplacian matvec, the five masked Grams forward and backward, four
    pool backwards, the 13 convs' bias+ReLU each way) and the precompute's
    five style Grams and bias+ReLU of 10 + 13 convs; nothing else (the
    post-smoothing is plain PyTorch)."""
    from dpst_tpu_torch.ops import kernels
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(lap_matvec=evals, gram_fwd=5 * evals + 5,
                gram_bwd=5 * evals, pool_bwd=4 * evals,
                bias_relu_fwd=13 * evals + 23, bias_relu_bwd=13 * evals)
    return need


def lbfgs_evaluations(rec: list) -> dict:
    """E and the per-step counts of an `optimize.record_evaluations` log.
    optax's `value_and_grad_from_state` evaluates afresh at the first step
    and after a search that left a non-finite value, and reuses the
    search's cached value otherwise: `fresh_expected`, so that E = 1 + Σ
    num_linesearch_steps where every search ends finite. `capped`: steps
    whose search took all 20 evaluations; `safe_steps`: searches that
    failed and took the safe step."""
    per = [r["evaluations"] for r in rec]
    ls = [r["num_linesearch_steps"] for r in rec]
    return {"E": sum(per), "per_step": per, "linesearch": ls,
            "fresh": sum(per) - sum(ls),
            "fresh_expected": 1 + sum(not r["value_finite"]
                                      for r in rec[:-1]),
            "capped": sum(n == 20 for n in ls),
            "safe_steps": sum(max(r["decrease_error"],
                                  r["curvature_error"]) > 0 for r in rec)}


def run_lbfgs(dev, gen, smi: str) -> dict:
    """The fifth path: `stylize` with PRESETS["config3"],
    optimizer="lbfgs", post_smooth=2, post_smooth_eps=1e-4 on a seeded
    512² pair with the four band masks, LBFGS_ITERS steps, the callback at
    the half. Counters reset just before and read just after, held to what
    the run's evaluation count E implies; the loss falls, the output is
    finite in [0, 255]; a LBFGS_SHORT-step rerun gives the first rows bit
    for bit, and so does its image with history_terms="full"; a
    checkpointed run resumed to twice its steps equals the straight run
    bit for bit; the post-smoothing on the card against the CPU; a 64²
    fp32 run on the card against the CPU; a profile of ten steps. Returns
    the main run's launch counts."""
    import tempfile

    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops.guided_filter import smooth_local_affine

    label = "config3 L-BFGS 512²"
    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = smooth_image(gen, dev, SIZE).cpu().numpy()
    cmask, smask = band_masks(K, SIZE, 0, 0), band_masks(K, SIZE, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs", post_smooth=2,
                              post_smooth_eps=1e-4, iterations=LBFGS_ITERS,
                              intermediate_interval=LBFGS_ITERS // 2)
    precompute_s = precompute_seconds(dev, cfg, params, content, style,
                                      cmask, smask)

    def run(cfg, callback=None, resume=False):
        return dpst_tpu_torch.stylize(
            content, style, cfg, content_masks=cmask, style_masks=smask,
            vgg_params=params, callback=callback, resume=resume,
            return_history=True)

    marks, evals_at = {}, {}
    with optimize.record_evaluations() as rec:
        def callback(step, image, hist):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()
            evals_at[step] = sum(r["evaluations"] for r in rec)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, hist = run(cfg, callback)
        wall_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = lbfgs_evaluations(rec)
    half = LBFGS_ITERS // 2
    window = marks[LBFGS_ITERS] - marks[half]
    steps_s = half / window
    evals_s = (evals_at[LBFGS_ITERS] - evals_at[half]) / window

    # the post-smoothing alone, on the output, card against CPU; its
    # device time from one call a trace (a few hundred kernels): traces of
    # ten calls have come back a few records short, the same each attempt
    content_t = torch.from_numpy(content).to(dev)
    out_t = torch.from_numpy(out).to(dev)
    sla_ms = device_ms(lambda: smooth_local_affine(content_t, out_t, 2,
                                                   1e-4), iters=1)
    card = smooth_local_affine(content_t, out_t, 2, 1e-4).cpu()
    plain = smooth_local_affine(torch.from_numpy(content),
                                torch.from_numpy(out), 2, 1e-4)
    sla_err = float((card - plain).abs().max())
    emit({"phase": "lbfgs", "path": label, "size": SIZE, "K": K,
          "iterations": LBFGS_ITERS, "compute_dtype": cfg.compute_dtype,
          "post_smooth": cfg.post_smooth, "steps_per_s": steps_s,
          "evaluations_per_s": evals_s, "evaluations": ev["E"],
          "fresh_evaluations": ev["fresh"],
          "evaluations_per_step": ev["per_step"],
          "num_linesearch_steps": ev["linesearch"],
          "capped_steps": ev["capped"], "safe_steps": ev["safe_steps"],
          "precompute_s": precompute_s, "wall_s": wall_s,
          "post_smooth_device_ms": sla_ms, "max_memory_gb": peak_gb,
          "first_row": hist[0].tolist(), "last_row": hist[-1].tolist(),
          "launches": launches, "nvidia_smi": smi})
    emit({"phase": "smooth_local_affine", "size": SIZE,
          "max_abs_err_vs_cpu": sla_err, "tol_abs": SLA_TOL,
          "device_ms": sla_ms})
    need = lbfgs_launches(ev["E"])
    bad = [f"{name} launched {launches[name]} times, E = {ev['E']} "
           f"implies {n}" for name, n in need.items()
           if launches[name] != n]
    if ev["fresh"] != ev["fresh_expected"]:
        bad.append(f"{ev['fresh']} fresh evaluations, optax's rule implies "
                   f"{ev['fresh_expected']}")
    if not hist[-1, 0] < hist[0, 0]:
        bad.append(f"total loss did not fall: {hist[0, 0]} -> "
                   f"{hist[-1, 0]}")
    if not (out.shape == (SIZE, SIZE, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 255.0):
        bad.append("output not finite (512, 512, 3) in [0, 255]")
    if not np.isfinite(hist).all() or hist[:, 1:].any():
        bad.append("history not finite, or columns 1-4 not zero")
    if not sla_err <= SLA_TOL:
        bad.append(f"smooth_local_affine card vs CPU {sla_err} > {SLA_TOL}")
    if bad:
        fail("lbfgs", f"{label}: " + "; ".join(bad))

    # reruns: the first rows bit for bit; the per-term history's extra
    # forward leaves the trajectory as it is
    short = dataclasses.replace(cfg, iterations=LBFGS_SHORT)
    out_s, hist_s = run(short)
    out_f, hist_f = run(dataclasses.replace(short, history_terms="full"))
    rerun = bool(np.array_equal(hist_s, hist[:LBFGS_SHORT]))
    full_same = bool(np.array_equal(out_f, out_s))
    emit({"phase": "rerun", "path": label, "iterations": LBFGS_SHORT,
          "bit_identical": rerun, "full_history_same_image": full_same,
          "full_history_photoreal_min": float(hist_f[:, 3].min()),
          "full_total_equals_cached": bool(np.array_equal(
              hist_f[:, 0], hist_s[:, 0]))})
    if not (rerun and full_same and hist_f[:, 3].min() >= -1.0):
        fail("rerun", f"{label}: rerun {rerun}, image with the full "
             f"history {full_same}, photoreal min {hist_f[:, 3].min()}")

    # checkpoint and resume against the straight run, both at interval 10
    ck = dataclasses.replace(cfg, intermediate_interval=LBFGS_SHORT)
    with tempfile.TemporaryDirectory() as tmp:
        straight, hist_st = run(dataclasses.replace(
            ck, iterations=2 * LBFGS_SHORT,
            checkpoint_dir=os.path.join(tmp, "straight")))
        run(dataclasses.replace(ck, iterations=LBFGS_SHORT,
                                checkpoint_dir=os.path.join(tmp, "ckpt")))
        resumed, hist_rs = run(dataclasses.replace(
            ck, iterations=2 * LBFGS_SHORT,
            checkpoint_dir=os.path.join(tmp, "ckpt")), resume=True)
    same = bool(np.array_equal(resumed, straight)
                and np.array_equal(hist_rs, hist_st[LBFGS_SHORT:]))
    emit({"phase": "resume", "path": label,
          "steps": [LBFGS_SHORT, 2 * LBFGS_SHORT], "bit_identical": same})
    if not same:
        fail("resume", f"{label}: the resumed run differs from the "
             "straight run")

    # ten steps past the half, profiled; the busy share per evaluation
    with optimize.record_evaluations() as prec:
        per_step, busy, step_ms, _, _ = profile_loop(run, cfg, half, 10)
    n_evals = sum(r["evaluations"] for r in prec[half:half + 10])
    busy_eval = busy * 10 / n_evals
    emit({"phase": "profile", "path": label, "steps": 10,
          "evaluations": n_evals, "device_ms_per_step": per_step,
          "device_busy_ms_per_step": busy,
          "device_busy_ms_per_evaluation": busy_eval,
          "step_ms_profiled": step_ms,
          "ms_per_evaluation_unprofiled": 1e3 / evals_s,
          "device_busy_share": busy_eval * evals_s / 1e3})
    run_lbfgs_reference(gen)
    return launches


def run_lbfgs_reference(gen, size: int = 64, k: int = 3) -> None:
    """A 64² fp32 L-BFGS run (regularization weight 100, LBFGS_SHORT
    steps) on the card against the same run on the CPU, beside the CPU
    run of a content image one fp32 ulp lower at every pixel: the
    trajectory's own sensitivity. The zoom's cubic interpolation and the
    curvature pairs amplify sub-ulp differences a thousandfold within a
    few steps even where every evaluation count agrees, so past the first
    row (the loss at the starting point, within 1e-5 relative)
    tests/test_golden.py's L-BFGS bounds hold: counts within ±2 a step,
    every row within 8e-2, the first 10 within 1e-2."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    content = smooth_image(gen, gen.device, size).cpu().numpy()
    style = smooth_image(gen, gen.device, size).cpu().numpy()
    cm, sm = stripe_masks(k, size)
    params = vgg.init_params(SEED)
    cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=LBFGS_SHORT, optimizer="lbfgs",
        regularization_weight=100.0)
    hists, counts = {}, {}
    lower = np.nextafter(content, np.float32(-np.inf))
    for where, image in (("cuda", content), ("cpu", content),
                         ("cpu, one ulp lower", lower)):
        with optimize.record_evaluations() as rec:
            _, hist = dpst_tpu_torch.stylize(
                image, style, cfg, content_masks=cm, style_masks=sm,
                vgg_params=params, return_history=True,
                device=where.split(",")[0])
        hists[where] = hist[:, 0]
        counts[where] = np.asarray([r["evaluations"] for r in rec])
    rel = {where: np.abs(h - hists["cpu"]) / np.abs(hists["cpu"])
           for where, h in hists.items() if where != "cpu"}
    emit({"phase": "reference", "path": "config3 L-BFGS", "size": size,
          "K": k, "iterations": LBFGS_SHORT, "compute_dtype": "float32",
          "rel_err_per_row": rel["cuda"].tolist(),
          "cpu_one_ulp_lower_rel_err_per_row":
              rel["cpu, one ulp lower"].tolist(),
          "evaluations": {w: c.tolist() for w, c in counts.items()},
          "tol_rel": {"row 0": 1e-5, "rows 0-9": 1e-2, "all": 8e-2,
                      "evaluations": 2}})
    err = rel["cuda"]
    bad = []
    if not err[0] <= 1e-5:
        bad.append(f"row 0 rel err {err[0]} > 1e-5")
    if not np.abs(counts["cuda"] - counts["cpu"]).max() <= 2:
        bad.append("evaluation counts differ by more than 2 at a step")
    if not (err.max() <= 8e-2 and err[:10].max() <= 1e-2):
        bad.append(f"rows rel err {err.max()} (bounds 1e-2 / 8e-2)")
    if bad:
        fail("reference", "config3 L-BFGS: " + "; ".join(bad))


def run_automatic_stages(dev) -> dict:
    """The segmentation phase, then the automatic and autotune paths (each
    on a generator of its own) with the automatic path's 64² reference;
    returns the two paths' launch counts."""
    seg_params = run_segmentation(
        dev, torch.Generator(device=dev).manual_seed(SEED + 12))
    auto_gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    launches = {"config3 automatic 512²": run_automatic(dev, auto_gen,
                                                        seg_params)}
    run_automatic_reference(dev, auto_gen, seg_params)
    launches["config3 autotune 512²"] = run_autotune(
        dev, torch.Generator(device=dev).manual_seed(SEED + 14), seg_params)
    return launches


def pspnet_gflop(size: int) -> float:
    """GFLOP (2 × multiply-adds) of PSPNet-50's convs on one size² image:
    the stem at stride 2, res2 after the stride-2 pool, res3_0_a there
    too, everything from res3_0_b on at stride 8, each PPM conv on its
    bin² grid."""
    from dpst_tpu_torch.models import pspnet
    h1 = -(-size // 2)
    h2 = -(-h1 // 2)
    h3 = -(-h2 // 2)
    total = 0
    for name, kh, kw, cin, cout in pspnet.CONV_SPECS:
        if name.startswith("stem"):
            n = h1
        elif name.startswith("res2") or name == "res3_0_a":
            n = h2
        elif name.startswith("ppm"):
            n = int(name[3:])
        else:
            n = h3
        total += 2 * n * n * kh * kw * cin * cout
    return total / 1e9


def label_flips(labels: torch.Tensor, scores: torch.Tensor,
                ref: torch.Tensor) -> dict:
    """The near-tie rule: `labels`, the argmax over dim 1 of `scores`,
    against the argmax of the reference's `ref` (same shape, on the CPU).
    A label may differ only where ref's top-2 margin is below twice the
    largest score difference."""
    diff = float((scores - ref).abs().max())
    top2 = ref.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) < 2 * diff
    flipped = labels != ref.argmax(1)
    return {"max_abs_diff": diff, "near_tie_share": float(near.float().mean()),
            "flipped": int(flipped.sum()),
            "flipped_outside_near_ties": int((flipped & ~near).sum())}


def run_segmentation(dev, gen) -> dict:
    """PSPNet-50 at full width (seeded weights) at its 473² eval size: fp32
    logits on the card against the CPU's (TF32 off), the labels by the
    near-tie rule, the bf16 forward (finite, labels in [0, 150), its
    agreement with the fp32 labels), `segment_batch` of SEG_BATCH 512²
    images against as many `segment` calls by the near-tie rule (its
    bit-equality printed) and against a rerun bit for bit; the bf16
    forward's device time, `segment_batch`'s images/s, the sliding
    protocol on a 512 × 768 image, `merge_classes` on the host, peak
    memory. Returns the weights (on the CPU)."""
    from dpst_tpu_torch import semantic_merge
    from dpst_tpu_torch.models import pspnet
    from dpst_tpu_torch.ops.resize import resize_image

    torch.cuda.reset_peak_memory_stats()
    params_cpu = pspnet.init_params(SEED)
    params = {k: {n: t.to(dev) for n, t in p.items()}
              for k, p in params_cpu.items()}
    n_weights = sum(p["w"].numel() for p in params_cpu.values())
    x = smooth_image(gen, dev, SEG_SIZE).cpu()[None]
    logits = pspnet._forward(params, x.to(dev), "float32").cpu()
    t0 = time.perf_counter()
    ref = pspnet._forward(params_cpu, x, "float32")
    cpu_s = time.perf_counter() - t0
    top = float(ref.abs().max())
    flips = label_flips(logits.argmax(1), logits, ref)
    x_dev = x.to(dev)
    logits16 = pspnet._forward(params, x_dev, "bfloat16")
    labels16 = logits16.argmax(1).cpu()
    finite16 = bool(torch.isfinite(logits16).all())
    del logits16

    imgs = torch.stack([smooth_image(gen, dev, SIZE)
                        for _ in range(SEG_BATCH)])
    batch = pspnet.segment_batch(params, imgs, "bfloat16", chunk=SEG_BATCH)
    single = torch.stack([pspnet.segment(params, imgs[i], "bfloat16")
                          for i in range(SEG_BATCH)])
    rerun = (torch.equal(pspnet.segment_batch(params, imgs, "bfloat16",
                                              chunk=SEG_BATCH), batch)
             and torch.equal(pspnet.segment(params, imgs[0], "bfloat16"),
                             single[0]))
    # the batch and the single calls by the near-tie rule, on the class
    # scores whose argmax they take: cuDNN may choose other algorithms
    # for a batch of eight than for one, and bf16 logits then round apart
    x473 = resize_image(imgs, (pspnet.EVAL_SIZE, pspnet.EVAL_SIZE))
    scores_b = pspnet._bilinear(pspnet._forward(params, x473, "bfloat16"),
                                (SIZE, SIZE), antialias=True)
    scores_1 = torch.cat([pspnet._bilinear(pspnet._forward(
        params, x473[i:i + 1], "bfloat16"), (SIZE, SIZE), antialias=True)
        for i in range(SEG_BATCH)])
    same_scores = (torch.equal(scores_b.argmax(1), batch)
                   and torch.equal(scores_1.argmax(1), single))
    batch_flips = label_flips(batch, scores_b, scores_1)
    del scores_b, scores_1, x473

    fwd = lambda: pspnet._forward(params, x_dev, "bfloat16")
    fwd_ms = device_total_ms(fwd, warmup=2, iters=5)
    fwd_events_ms = cuda_ms(fwd, warmup=1, iters=10)
    seg = lambda: pspnet.segment_batch(params, imgs, "bfloat16",
                                       chunk=SEG_BATCH)
    seg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        seg()
    torch.cuda.synchronize()
    images_s = 3 * SEG_BATCH / (time.perf_counter() - t0)
    wide = smooth_image(gen, dev, 768)[:512]
    slide = lambda: pspnet.segment(params, wide, "bfloat16",
                                   protocol="sliding", base_size=512,
                                   flip=True)
    slide()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slide_labels = slide()
    torch.cuda.synchronize()
    slide_ms = (time.perf_counter() - t0) * 1e3
    seg_c, seg_s = batch[0].cpu().numpy(), batch[1].cpu().numpy()
    semantic_merge.merge_classes(seg_c, seg_s)
    t0 = time.perf_counter()
    for _ in range(5):
        merged = semantic_merge.merge_classes(seg_c, seg_s)
    merge_ms = (time.perf_counter() - t0) * 1e3 / 5
    gflop = pspnet_gflop(SEG_SIZE)
    emit({"phase": "segmentation", "size": SEG_SIZE, "classes": 150,
          "conv_weights": n_weights, "weights": f"He-init seed {SEED}",
          "gflop_per_image": gflop,
          "fp32_max_abs_logit_diff_vs_cpu": flips["max_abs_diff"],
          "fp32_max_abs_logit": top, "tol_rel": SEG_LOGIT_TOL,
          "fp32_labels_vs_cpu": flips, "cpu_fp32_forward_s": cpu_s,
          "bf16_finite": finite16,
          "bf16_vs_fp32_label_agreement": float(
              (labels16 == logits.argmax(1)).float().mean()),
          "segment_batch": {"N": SEG_BATCH, "chunk": SEG_BATCH,
                            "bit_equal_to_segment_calls": bool(torch.equal(
                                batch, single)),
                            "vs_segment_calls": batch_flips,
                            "labels_are_argmax_of_scores": same_scores,
                            "rerun_bit_identical": bool(rerun)},
          "bf16_forward_device_ms": fwd_ms,
          "bf16_forward_events_ms": fwd_events_ms,
          "bf16_forward_tflop_s": gflop / fwd_ms,
          "segment_batch_images_per_s": images_s,
          "sliding_512x768_flip_ms": slide_ms,
          "sliding_classes": int(slide_labels.unique().numel()),
          "merge_classes_host_ms": merge_ms,
          "merged_classes": len(merged[2]),
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    bad = []
    if not flips["max_abs_diff"] <= SEG_LOGIT_TOL * top:
        bad.append(f"fp32 logits differ by {flips['max_abs_diff']} > "
                   f"{SEG_LOGIT_TOL} x {top}")
    if flips["flipped_outside_near_ties"]:
        bad.append(f"{flips['flipped_outside_near_ties']} fp32 labels "
                   "differ from the CPU's outside near ties")
    if not (finite16 and int(batch.min()) >= 0 and int(batch.max()) < 150):
        bad.append("bf16 logits not finite, or labels outside [0, 150)")
    if batch_flips["flipped_outside_near_ties"] or not same_scores:
        bad.append(f"segment_batch differs from segment at "
                   f"{batch_flips['flipped_outside_near_ties']} pixels "
                   "outside near ties (or the scores are not its own)")
    if not rerun:
        bad.append("a rerun changed the label maps")
    if bad:
        fail("segmentation", "; ".join(bad))
    del params, imgs
    torch.cuda.empty_cache()
    return params_cpu


def automatic_launches(steps: int) -> dict:
    """What config3 with automatic masks launches at 512², K8 classes:
    the main path's kernels (segmentation and the class merge launch
    none): per step five Grams forward and backward, four pool backwards,
    one Laplacian matvec, the 13 convs' bias+ReLU each way; the
    precompute's five style Grams and bias+ReLU of 10 + 13 convs."""
    from dpst_tpu_torch.ops import kernels
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(lap_matvec=steps, gram_fwd=5 * steps + 5,
                gram_bwd=5 * steps, pool_bwd=4 * steps,
                bias_relu_fwd=13 * steps + 23, bias_relu_bwd=13 * steps)
    return need


def run_automatic(dev, gen, seg_params: dict) -> dict:
    """`stylize(content, style, PRESETS["config3"])` with no masks: PSPNet
    on both images, the merge, K8 padded masks, then the config3 loop
    (AUTO_ITERS steps, bf16, seeded VGG-19 and PSPNet). The masks alone
    first (timed, twice: bit-identical), then the precompute alone, then
    the path with the counters reset just before and read just after.
    Checks the losses, the output, the masks (Σ_k m_k = 1, at most K8
    classes), the counters and a bit-identical short rerun."""
    import dpst_tpu_torch
    from dpst_tpu_torch import segmentation
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels

    label = "config3 automatic 512²"
    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = textured_image(gen, dev, SIZE).cpu().numpy()
    params = vgg.get_params(seed=SEED, device=dev)
    seg = {k: {n: t.to(dev) for n, t in p.items()}
           for k, p in seg_params.items()}
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              iterations=AUTO_ITERS,
                              intermediate_interval=AUTO_ITERS // 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm, sm, ids = segmentation.automatic_masks(content, style, cfg, seg,
                                               device=dev)
    seg_s = time.perf_counter() - t0
    cm2, sm2, ids2 = segmentation.automatic_masks(content, style, cfg, seg,
                                                  device=dev)
    masks_rerun = bool(torch.equal(cm, cm2) and torch.equal(sm, sm2)
                       and ids == ids2)
    cm, sm = cm.cpu().numpy(), sm.cpu().numpy()
    precompute_s = precompute_seconds(dev, cfg, params, content, style,
                                      cm, sm)
    marks = {}

    def callback(step, image, hist):
        torch.cuda.synchronize()
        marks[step] = time.perf_counter()

    def run(cfg, callback=None):
        return dpst_tpu_torch.stylize(content, style, cfg, vgg_params=params,
                                      seg_params=seg, callback=callback,
                                      return_history=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, hist = run(cfg, callback)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    half = AUTO_ITERS // 2
    loop_its = half / (marks[AUTO_ITERS] - marks[half])
    _, hist_s = run(dataclasses.replace(cfg, iterations=RERUN_ITERS))
    rerun = bool(np.array_equal(hist_s, hist[:RERUN_ITERS]))
    emit_profile(label, 5, 10, run, cfg, 1e3 / loop_its)
    emit({"phase": "automatic", "path": label, "size": SIZE,
          "K": cm.shape[0], "merged_classes": len(ids), "class_ids": ids,
          "content_class_pixels": cm.sum(axis=(1, 2)).tolist(),
          "iterations": AUTO_ITERS, "compute_dtype": cfg.compute_dtype,
          "segmentation_s": seg_s, "precompute_s": precompute_s,
          "loop_it_s": loop_its, "wall_s": wall_s,
          "projected_500_step_s": seg_s + precompute_s + 500 / loop_its,
          "first_row": hist[0].tolist(), "last_row": hist[-1].tolist(),
          "launches": launches, "max_memory_gb": peak,
          "masks_rerun_bit_identical": masks_rerun,
          "history_rerun_bit_identical": rerun})
    need = automatic_launches(AUTO_ITERS)
    bad = [f"{name} launched {launches[name]} times, the path implies {n}"
           for name, n in need.items() if launches[name] != n]
    if not hist[-1, 0] < hist[0, 0]:
        bad.append(f"total loss did not fall: {hist[0, 0]} -> "
                   f"{hist[-1, 0]}")
    if not hist[:, 3].min() >= -1.0:
        bad.append(f"photoreal term {hist[:, 3].min()} < -1")
    if not (out.shape == (SIZE, SIZE, 3) and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 255.0):
        bad.append("output not finite (512, 512, 3) in [0, 255]")
    if not (cm.shape[0] == sm.shape[0] == K8 and len(ids) <= K8
            and np.all(cm.sum(0) == 1.0) and np.all(sm.sum(0) == 1.0)):
        bad.append(f"masks: K {cm.shape[0]}, {len(ids)} classes, "
                   "Σ_k m_k not 1 at every pixel")
    if not (masks_rerun and rerun):
        bad.append(f"reruns: masks {masks_rerun}, history {rerun}")
    if bad:
        fail("automatic", f"{label}: " + "; ".join(bad))
    return launches


def run_automatic_reference(dev, gen, seg_params: dict, size: int = 64
                            ) -> None:
    """The automatic path at 64² in fp32: the card's label maps against
    the CPU's by the near-tie rule (the resize protocol's scores), then
    the CPU's whole automatic `stylize` against the card's `stylize` given
    the CPU's masks, histories within 1e-3."""
    import dpst_tpu_torch
    from dpst_tpu_torch import segmentation
    from dpst_tpu_torch.models import pspnet, vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops.resize import resize_image
    content = smooth_image(gen, gen.device, size).cpu().numpy()
    style = textured_image(gen, gen.device, size).cpu().numpy()
    cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=5, regularization_weight=100.0)
    params = vgg.init_params(SEED)
    seg = {k: {n: t.to(dev) for n, t in p.items()}
           for k, p in seg_params.items()}
    flips = []
    for img in (content, style):
        scores = {}
        for where, p in ((dev, seg), ("cpu", seg_params)):
            x = resize_image(torch.from_numpy(img).to(where)[None],
                             (pspnet.EVAL_SIZE, pspnet.EVAL_SIZE))
            logits = pspnet._forward(p, x, "float32")
            scores[str(where)] = pspnet._bilinear(logits, (size, size),
                                                  antialias=True).cpu()
        card = scores[str(dev)]
        labels = pspnet.segment(seg, torch.from_numpy(img).to(dev),
                                "float32").cpu()
        if not torch.equal(labels, card.argmax(1)[0]):
            fail("reference", "automatic: segment's labels are not the "
                 "argmax of its scores")
        flips.append(label_flips(card.argmax(1), card, scores["cpu"]))
    cm, sm, ids = segmentation.automatic_masks(content, style, cfg,
                                               seg_params, device="cpu")
    cm, sm = cm.numpy(), sm.numpy()
    _, h_cpu = dpst_tpu_torch.stylize(content, style, cfg, vgg_params=params,
                                      seg_params=seg_params,
                                      return_history=True, device="cpu")
    kernels.reset_launches()
    _, h_card = dpst_tpu_torch.stylize(content, style, cfg,
                                       content_masks=cm, style_masks=sm,
                                       vgg_params=params,
                                       return_history=True, device=dev)
    launches = dict(kernels.LAUNCHES)
    rel = np.abs(h_card - h_cpu) / np.maximum(np.abs(h_cpu).max(axis=0),
                                              1e-30)
    worst, tol = float(rel.max()), 1e-3
    emit({"phase": "reference", "path": "config3 automatic", "size": size,
          "K": cm.shape[0], "merged_classes": len(ids),
          "iterations": len(h_cpu), "compute_dtype": "float32",
          "labels_vs_cpu": flips, "max_rel_err_vs_cpu": worst,
          "tol_rel": tol, "card_launches": launches})
    bad = [f"{f['flipped_outside_near_ties']} labels differ outside near "
           "ties" for f in flips if f["flipped_outside_near_ties"]]
    if not worst <= tol:
        bad.append(f"card vs CPU history rel err {worst} > {tol}")
    if bad:
        fail("reference", "config3 automatic: " + "; ".join(bad))


def autotune_launches(steps: int) -> dict:
    """What the Γ sweep of config3 launches at 512², K8 classes, for
    `steps` Adam steps of its rounds (each round's candidates run as one
    batch, whose kernels launch once for all of them): the resolved
    config's conv1_1 on the fused pair (one each a step), the other four
    style taps on gram_fwd / gram_bwd, four pool backwards, one Laplacian
    matvec, the 13 convs' bias+ReLU each way a step; the precompute's five
    style Grams and bias+ReLU of 10 + 13 convs once a call (NIMA and
    PSPNet launch none)."""
    from dpst_tpu_torch.ops import kernels
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(lap_matvec=steps, gram_fwd=4 * steps + 5,
                gram_bwd=4 * steps, gram_relu_fwd=steps,
                gram_relu_bwd=steps, pool_bwd=4 * steps,
                bias_relu_fwd=13 * steps + 23, bias_relu_bwd=13 * steps)
    return need


def run_autotune(dev, gen, seg_params: dict) -> dict:
    """`autotune(content, style, PRESETS["config3"], rounds=TUNE_ROUNDS)`
    with the four default Γ, TUNE_ITERS steps a candidate, automatic masks,
    at 512²: each round's candidates run as one batch; the counters reset
    just before and read just after and held to the rounds' steps (one
    batch's count); scores finite in [1, 10]; the best Γ the best-scored
    candidate; the best image the batch's image for that Γ, bit for bit;
    against `stylize` under the sweep's resolved config at that Γ (one
    image where the sweep ran four: bf16 cuDNN rounds them apart) within
    the batch path's BATCH_PIXEL_TOL; the fp32 NIMA scores of the final
    images, card against CPU, within NIMA_TOL; then an fp32 sweep at 64²
    against `stylize` within the JAX package's batch bounds
    (`run_autotune_reference`). Times a call, a one-round call (their
    difference: one sweep; the one-round call again, profiled by kernel
    group), and NIMA's bf16 forward at B = 4."""
    import importlib

    import dpst_tpu_torch
    from dpst_tpu_torch.models import nima, vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops.resize import resize_image
    tune = importlib.import_module("dpst_tpu_torch.autotune")

    label = "config3 autotune 512²"
    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = textured_image(gen, dev, SIZE).cpu().numpy()
    params = vgg.get_params(seed=SEED, device=dev)
    seg = {k: {n: t.to(dev) for n, t in p.items()}
           for k, p in seg_params.items()}
    nima_cpu = nima.init_params(SEED)
    nima_dev = {k: {n: t.to(dev) for n, t in p.items()}
                for k, p in nima_cpu.items()}
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              iterations=TUNE_ITERS)
    kw = dict(vgg_params=params, nima_params=nima_dev, seg_params=seg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = dpst_tpu_torch.autotune(content, style, cfg, rounds=TUNE_ROUNDS,
                                  **kw)
    call_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # a one-round call (its time: the call's less one sweep), then the
    # same call profiled: device time by kernel group over its steps
    # (PSPNet, the precompute and NIMA included, under 1 % of it), its
    # busy share against the unprofiled call
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dpst_tpu_torch.autotune(content, style, cfg, rounds=1, **kw)
    torch.cuda.synchronize()
    one_round_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dpst_tpu_torch.autotune(content, style, cfg, rounds=1, **kw)
        torch.cuda.synchronize()
    # a step: one batched step of the round's four candidates
    round_steps = TUNE_ITERS
    groups: dict[str, float] = {}
    for ev in prof.events():
        if on_device(ev):
            g = kernel_group(ev.name)
            groups[g] = (groups.get(g, 0.0)
                         + ev.time_range.elapsed_us() / 1e3 / round_steps)
    busy = sum(groups.values())
    emit({"phase": "profile", "path": label + ", one round",
          "steps": round_steps, "device_ms_per_step": dict(sorted(
              groups.items(), key=lambda kv: -kv[1])),
          "device_busy_ms_per_step": busy,
          "call_ms_per_step_unprofiled": one_round_s * 1e3 / round_steps,
          "device_busy_share": busy * round_steps / one_round_s / 1e3})

    best = dpst_tpu_torch.stylize(
        content, style, dataclasses.replace(tune.resolve_config(cfg),
                                            style_weight=res.best_gamma),
        vgg_params=params, seg_params=seg)
    images = torch.from_numpy(res.images)
    card = nima.nima_score(nima_dev, images.to(dev), "float32").cpu()
    plain = nima.nima_score(nima_cpu, images, "float32")
    nima_err = float((card - plain).abs().max())
    x4 = resize_image(images.to(dev), (nima.EVAL_SIZE, nima.EVAL_SIZE))
    nima_ms = device_total_ms(
        lambda: nima.score_distribution(nima_dev, x4, "bfloat16"))
    steps = TUNE_ROUNDS * TUNE_ITERS
    last = list(res.gammas[-len(tune.DEFAULT_GAMMAS):])
    d = np.abs(best - res.best_image)
    emit({"phase": "autotune", "path": label, "size": SIZE, "K": K8,
          "gammas": res.gammas.tolist(), "scores": res.scores.tolist(),
          "best_gamma": res.best_gamma, "rounds": TUNE_ROUNDS,
          "steps_per_candidate": TUNE_ITERS, "call_s": call_s,
          "one_round_call_s": one_round_s,
          "sweep_s": call_s - one_round_s,
          "nima_bf16_b4_device_ms": nima_ms,
          "nima_fp32_max_abs_err_vs_cpu": nima_err, "nima_tol": NIMA_TOL,
          "best_vs_stylize": {"bit_equal": bool(np.array_equal(
              best, res.best_image)), "pixel_max": float(d.max()),
              "pixel_mean": float(d.mean()), "tol_mean": BATCH_PIXEL_TOL},
          "launches": launches, "max_memory_gb": peak})
    bad = [f"{name} launched {launches[name]} times, the sweep implies {n}"
           for name, n in autotune_launches(steps).items()
           if launches[name] != n]
    if not (np.isfinite(res.scores).all() and res.scores.min() >= 1.0
            and res.scores.max() <= 10.0):
        bad.append(f"scores {res.scores.tolist()} not finite in [1, 10]")
    if res.best_gamma != float(res.gammas[int(np.argmax(res.scores))]):
        bad.append(f"best Γ {res.best_gamma} is not the best-scored one")
    if res.best_gamma in last and not np.array_equal(
            res.best_image, res.images[last.index(res.best_gamma)]):
        bad.append("the best image is not the batch's image for its Γ")
    if not d.mean() <= BATCH_PIXEL_TOL:
        bad.append(f"the best image is {d.mean()} from stylize at its Γ "
                   f"(mean |pixel|) > {BATCH_PIXEL_TOL}")
    if not nima_err <= NIMA_TOL:
        bad.append(f"fp32 NIMA card vs CPU {nima_err} > {NIMA_TOL}")
    if bad:
        fail("autotune", f"{label}: " + "; ".join(bad))
    run_autotune_reference(gen, params)
    return launches


def run_autotune_reference(gen, params: dict, size: int = 64) -> None:
    """An fp32 sweep of two Γ at 64² (3 stripe masks, 5 steps) on the card:
    each candidate's image against `stylize` of that candidate alone
    within the JAX package's own batch ≡ sequential bounds
    (tests/test_sharding.py: rtol 1e-2, atol 0.25 of [0, 255])."""
    import importlib

    import dpst_tpu_torch
    from dpst_tpu_torch.models import nima
    tune = importlib.import_module("dpst_tpu_torch.autotune")
    content = smooth_image(gen, gen.device, size).cpu().numpy()
    style = textured_image(gen, gen.device, size).cpu().numpy()
    cm, sm = stripe_masks(3, size)
    cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32", iterations=5,
                                       regularization_weight=100.0)
    nima_p = {k: {n: t.cuda() for n, t in p.items()}
              for k, p in nima.init_params(SEED).items()}
    res = dpst_tpu_torch.autotune(content, style, cfg, gammas=(3.0, 300.0),
                                  content_masks=cm, style_masks=sm,
                                  vgg_params=params, nima_params=nima_p)
    worst = 0.0
    for gamma, image in zip(res.gammas, res.images):
        out = dpst_tpu_torch.stylize(
            content, style, dataclasses.replace(
                tune.resolve_config(cfg), style_weight=float(gamma)),
            content_masks=cm, style_masks=sm, vgg_params=params)
        worst = max(worst, float((np.abs(image - out)
                                  - 1e-2 * np.abs(out)).max()))
    emit({"phase": "reference", "path": "autotune fp32 64², two Γ",
          "max_excess_over_rtol_1e-2": worst, "atol": 0.25})
    if not worst <= 0.25:
        fail("reference", f"fp32 sweep vs stylize: {worst} > atol 0.25 "
             "beyond rtol 1e-2")


# --- the batch path (stylize_batch, B pairs as one batched loop) -----------

def batched_input(kind: str, b: int, c: int, p: int, k: int, dtype, dev,
                  gen):
    """Operands of B distinct pairs for the batched Gram kernels: f (B, C,
    P) ("gram": |randn|) or the raw tap z ("relu": as `relu_gram_input`,
    with its bias shared), m² (B, K, P) of soft masks drawn per pair, and
    symmetrized cotangents s (B, K, C, C)."""
    if kind == "relu":
        parts = [relu_gram_input(c, p, k, dtype, dev, gen) for _ in range(b)]
        bias = parts[0][1]
        z = torch.stack([z_i - (b_i - bias)[:, None].to(dtype)
                         for z_i, b_i, _, _ in parts]).contiguous()
        return (z, bias, torch.stack([q[2] for q in parts]),
                torch.stack([q[3] for q in parts]))
    f = torch.randn((b, c, p), generator=gen, device=dev).abs().to(dtype)
    m = torch.rand((b, k, p), generator=gen, device=dev)
    d = torch.randn((b, k, c, c), generator=gen, device=dev)
    return (f, None, (m * m).to(dtype),
            (d + d.transpose(-1, -2)).to(dtype).contiguous())


def pair_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got − ref|, the largest over the pairs of a pair's max error
    over its own max |ref|)."""
    errs = [rel_err(got[i], ref[i]) for i in range(got.shape[0])]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def pairs_equal_alone(got, alone) -> bool:
    """Each pair of a batched kernel's output bit-equal to the same
    kernel's launch on that pair alone (`alone`: the B one-pair outputs)."""
    return all(torch.equal(got[i], a) for i, a in enumerate(alone))


def batched_row(name: str, shape: list, b: int, k, dtype: str, in_step: bool,
                got, ref, tol: float, run, looped, plain, nbytes: float,
                ops: float, lib=None, lib_call: str | None = None,
                **extra) -> dict:
    """One batched kernel's row: its B pairs against the plain version
    pair by pair (each pair's error over its own max |ref|) and, bit for
    bit, against the B one-pair launches of the same kernel (`looped`,
    whose outputs it returns); its device time in turns with those
    launches (`looped_ms`, the yardstick of ROADMAP item 14; never on the
    path); back-to-back event times, the plain version's time, the bound
    of the B pairs' bytes or operations and, where one PyTorch call
    computes the same function for the batch, that call's device time."""
    err, rel = pair_errors(got, ref)
    equal = pairs_equal_alone(got, looped())
    times = plans_in_turns({"ms": run, "looped_ms": looped})
    times["events_ms"] = cuda_ms(run)
    times["looped_events_ms"] = cuda_ms(looped)
    bnd, by = bound_ms(nbytes, ops, dtype)
    row = {"phase": "kernel", "name": name, "B": b, "shape": shape, "K": k,
           "dtype": dtype, "in_step": in_step, "max_abs_err": err,
           "rel_err": rel, "tol_rel": tol,
           "bit_equal_to_one_pair_launches": equal, **times,
           "plain_ms": cuda_ms(plain, warmup=1, iters=3),
           "bound_ms": bnd, "bound_by": by,
           "library_ms": None if lib is None else device_ms(lib), **extra}
    if lib_call:
        row["library_call"] = lib_call
    emit(row)
    if not rel <= tol:
        fail("kernels", f"{name} B={b} {dtype} {shape} K={k}: rel err "
             f"{rel} > {tol}")
    if not equal:
        fail("kernels", f"{name} B={b} {dtype} {shape} K={k}: a pair "
             "differs from its one-pair launch")
    return row


def check_batched(dev, gen):
    """The five kernels that take a batch grid dimension, at the batch
    path's shapes (B = BATCH distinct pairs at 512², K = 4 masks drawn per
    pair): `lap_matvec` (bf16 path's fp32 Laplacian), `gram_fwd` and
    `gram_bwd` at conv2_1 … conv5_1 (and `gram_fwd` at conv1_1, which only
    the precompute's style Grams take), the fused pair at conv1_1, and
    `pool_bwd` on the pairs folded into its channels. Each against its
    plain version pair by pair and timed against BATCH one-pair launches
    of itself (`batched_row`)."""
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    from dpst_tpu_torch.ops import pool_cuda
    rows, b = [], BATCH
    # the Laplacian: distinct stats and v per pair
    img = torch.rand((b, SIZE, SIZE, 3), generator=gen, device=dev)
    packed = torch.stack([lapc.pack_stats(lap.precompute_stats(i))
                          for i in img])
    v3 = torch.rand((b, 3, SIZE, SIZE), generator=gen, device=dev)
    hw = SIZE * SIZE
    rows.append(batched_row(
        "lap_matvec", [3, SIZE, SIZE], b, None, "float32", True,
        lapc.lap_matvec(packed, v3), lapc.lap_matvec_plain(packed, v3), 1e-5,
        lambda: lapc.lap_matvec(packed, v3),
        lambda: [lapc.lap_matvec(packed[i], v3[i]) for i in range(b)],
        lambda: lapc.lap_matvec_plain(packed, v3), 20 * b * hw * 4,
        LAP_OPS_PER_PIXEL * b * hw, strip_rows=lapc.lap_plan(SIZE, SIZE, b)))
    # the Γ sweep's form: one pair's stats shared by every candidate
    shared = packed[:1].expand(TUNE_CANDIDATES, -1, -1, -1)
    v4 = v3[:TUNE_CANDIDATES].contiguous()
    rows.append(batched_row(
        "lap_matvec", [3, SIZE, SIZE], TUNE_CANDIDATES, None, "float32",
        False, lapc.lap_matvec(shared, v4),
        lapc.lap_matvec_plain(packed[0], v4), 1e-5,
        lambda: lapc.lap_matvec(shared, v4),
        lambda: [lapc.lap_matvec(packed[0], v4[i])
                 for i in range(TUNE_CANDIDATES)],
        lambda: lapc.lap_matvec_plain(packed[0], v4),
        (14 + 6 * TUNE_CANDIDATES) * hw * 4,
        LAP_OPS_PER_PIXEL * TUNE_CANDIDATES * hw, stats="shared, stride 0"))
    del img, packed, v3, shared, v4
    # the Gram pair: conv1_1 … conv5_1 (conv1_1 in the precompute only)
    for c, p in GRAM_SHAPES:
        in_step = c != 64
        f, _, m2, s = batched_input("gram", b, c, p, K, torch.bfloat16, dev,
                                    gen)
        nbytes, ops = gram_fwd_work(c, p, K, 2)
        rows.append(batched_row(
            "gram_fwd", [c, p], b, K, "bfloat16", in_step,
            gs.gram_fwd(f, m2), gs.gram_fwd_plain(f, m2), 1e-3,
            lambda: gs.gram_fwd(f, m2),
            lambda: [gs.gram_fwd(f[i], m2[i]) for i in range(b)],
            lambda: gs.gram_fwd_plain(f, m2),
            b * nbytes, b * ops,
            lambda: torch.matmul(f.unsqueeze(1), (f.unsqueeze(1)
                                 * m2.unsqueeze(2)).transpose(-1, -2)),
            "torch.matmul", plan=gs.fwd_plan(c, p, K, b)))
        if in_step:
            a = s.transpose(1, 2).reshape(b, c, K * c)
            rows.append(batched_row(
                "gram_bwd", [c, p], b, K, "bfloat16", True,
                gs.gram_bwd(f, m2, s), gs.gram_bwd_plain(f, m2, s), 1e-2,
                lambda: gs.gram_bwd(f, m2, s),
                lambda: [gs.gram_bwd(f[i], m2[i], s[i]) for i in range(b)],
                lambda: gs.gram_bwd_plain(f, m2, s),
                b * gram_bwd_work(c, p, K, 2)[0], b * ops,
                lambda: torch.matmul(a, (f.unsqueeze(1) * m2.unsqueeze(2))
                                     .reshape(b, K * c, p)),
                "torch.matmul", plan=gs.bwd_plan(c, p, K, b)))
        del f, m2, s
        torch.cuda.empty_cache()
    # the fused pair at conv1_1; its yardstick: torch.matmul on the cooked
    # operand (less work)
    c, p = RELU_SHAPE_512
    z, bias, m2, s = batched_input("relu", b, c, p, K, torch.bfloat16, dev,
                                   gen)
    f = g2._cook(z.reshape(-1, p), bias.repeat(b)).reshape(b, c, p)
    ops = 2.0 * b * K * c * c * p
    yard = "yardstick: torch.matmul on relu(z + b), less work"
    rows.append(batched_row(
        "gram_relu_fwd", [c, p], b, K, "bfloat16", True,
        g2.gram_relu_fwd(z, bias, m2), g2.gram_relu_fwd_plain(z, bias, m2),
        1e-3, lambda: g2.gram_relu_fwd(z, bias, m2),
        lambda: [g2.gram_relu_fwd(z[i], bias, m2[i]) for i in range(b)],
        lambda: g2.gram_relu_fwd_plain(z, bias, m2),
        b * ((c * p + K * p) * 2 + K * c * c * 4) + c * 2, ops,
        lambda: torch.matmul(f.unsqueeze(1), (f.unsqueeze(1)
                             * m2.unsqueeze(2)).transpose(-1, -2)), yard,
        plan=gs.fwd_plan(c, p, K, b)))
    ref = g2.gram_relu_bwd_plain(z, bias, m2, s)
    a = s.transpose(1, 2).reshape(b, c, K * c)
    rows.append(batched_row(
        "gram_relu_bwd", [c, p], b, K, "bfloat16", True,
        g2.gram_relu_bwd(z, bias, m2, s), ref,
        max(out_tol(ref[i], "bfloat16") for i in range(b)),
        lambda: g2.gram_relu_bwd(z, bias, m2, s),
        lambda: [g2.gram_relu_bwd(z[i], bias, m2[i], s[i])
                 for i in range(b)],
        lambda: g2.gram_relu_bwd_plain(z, bias, m2, s),
        b * (2 * c * p + K * p + K * c * c) * 2 + c * 2, ops,
        lambda: torch.matmul(a, (f.unsqueeze(1) * m2.unsqueeze(2))
                             .reshape(b, K * c, p)), yard,
        plan=g2.relu_bwd_plan(c, p, K, b)))
    del z, bias, m2, s, f, ref
    torch.cuda.empty_cache()
    # the pool backward: the pairs folded into its channels
    for c, h, w in POOL_SHAPES:
        x, y, g = tied_pool_input(b * c, h, w, torch.bfloat16, dev, gen)
        n = b * c * h * w
        rows.append(batched_row(
            "pool_bwd", [c, h, w], b, None, "bfloat16", True,
            pool_cuda.maxpool2_bwd(x, y, g).reshape(b, c, h, w),
            pool_cuda.maxpool2_bwd_plain(x, y, g).reshape(b, c, h, w), 0.0,
            lambda: pool_cuda.maxpool2_bwd(x, y, g),
            lambda: [pool_cuda.maxpool2_bwd(x[i * c:(i + 1) * c],
                                            y[i * c:(i + 1) * c],
                                            g[i * c:(i + 1) * c])
                     for i in range(b)],
            lambda: pool_cuda.maxpool2_bwd_plain(x, y, g), 2.5 * n * 2,
            POOL_OPS_PER_WINDOW * n / 4, folded=[b * c, h, w]))
        del x, y, g
    check_batched_edges(dev, gen)
    return rows


def check_batched_wbwd_conv(dev, gen):
    """`gram_wbwd` and `conv3x3` with their batch grid dimension, at the
    pallas-route batch's shapes (B = BATCH distinct pairs at 512²):
    `gram_wbwd` at conv1_1 … conv5_1 (K = 4 soft masks drawn per pair;
    conv1_1 takes the fused pair on that path, so its row is not in the
    step), `conv3x3` at conv1_2 … conv5_1 forward and input gradient on
    weights packed once. bf16 rows against the plain version pair by pair
    and timed in turns with BATCH one-pair launches (`batched_row`); the
    same shapes in fp32 (the CUDA-core tiles) against the plain version;
    then the edge cases of BATCH_WBWD_EDGES and BATCH_CONV_EDGES."""
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import conv_cuda as cc
    from dpst_tpu_torch.ops import gram_pallas as gp
    rows, b, worst = [], BATCH, {}
    for dtype in ("bfloat16", "float32"):
        cdt = getattr(torch, dtype)
        isz = 2 if dtype == "bfloat16" else 4
        for c, p in GRAM_SHAPES:
            f, _, m2, s = batched_input("gram", b, c, p, K, cdt, dev, gen)
            got, ref = gp.gram_wbwd(f, m2, s), gp.gram_wbwd_plain(f, m2, s)
            tol = max(out_tol(ref[i], dtype) for i in range(b))
            if dtype == "bfloat16":
                a = s.transpose(1, 2).reshape(b, c, K * c)
                nbytes, ops = gram_bwd_work(c, p, K, isz)
                rows.append(batched_row(
                    "gram_wbwd", [c, p], b, K, dtype, c != 64, got, ref, tol,
                    lambda: gp.gram_wbwd(f, m2, s),
                    lambda: [gp.gram_wbwd(f[i], m2[i], s[i])
                             for i in range(b)],
                    lambda: gp.gram_wbwd_plain(f, m2, s),
                    b * nbytes, b * ops,
                    lambda: torch.matmul(a, (f.unsqueeze(1)
                                             * m2.unsqueeze(2))
                                         .reshape(b, K * c, p)),
                    "yardstick: gram_bwd's torch.matmul, weighting before "
                    "the product", plan=gp.wbwd_plan(c, p, K, b),
                    masks="soft"))
            else:
                worst[f"gram_wbwd B={b} {dtype} {c}x{p}"] = rel = (
                    pair_errors(got, ref)[1])
                if not rel <= tol:
                    fail("kernels", f"gram_wbwd B={b} {dtype} {c}x{p}: rel "
                         f"err {rel} > {tol}")
                if not pairs_equal_alone(got, [gp.gram_wbwd(
                        f[i], m2[i], s[i]) for i in range(b)]):
                    fail("kernels", f"gram_wbwd B={b} {dtype} {c}x{p}: a "
                         "pair differs from its one-pair launch")
            del f, m2, s, got, ref
            torch.cuda.empty_cache()
        vgg.set_exact_backends(cdt)
        timed = {}
        for cin, cout, hw in CONV_SHAPES:
            x = torch.randn((b, cin, hw, hw), generator=gen,
                            device=dev).to(cdt)
            wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                  * math.sqrt(2.0 / (9 * cin))).to(cdt)
            g = torch.randn((b, cout, hw, hw), generator=gen,
                            device=dev).to(cdt)
            ft = cc.flip_transpose_weights(wt)
            cases = (("forward", x, wt, "F.conv2d",
                      lambda: F.conv2d(x, wt, padding=1)),
                     ("input_grad", g, ft, "torch.nn.grad.conv2d_input",
                      lambda: torch.nn.grad.conv2d_input(
                          (b, cin, hw, hw), wt, g, padding=1)))
            for direction, a, w_, lib_name, lib in cases:
                wp = cc.pack_weights(w_)
                got, ref = cc.conv3x3_same(a, wp), cc.conv3x3_plain(a, w_)
                tol = max(out_tol(ref[i], dtype) for i in range(b))
                k_in, k_out = w_.shape[1], w_.shape[0]
                key = (direction, k_in, k_out, hw)
                if dtype == "float32" or key in timed:
                    rel = pair_errors(got, ref)[1]
                    if not pairs_equal_alone(got, [cc.conv3x3_same(a[i], wp)
                                                   for i in range(b)]):
                        fail("kernels", f"conv3x3 B={b} {dtype} {direction}"
                             f" {k_in}->{k_out} at {hw}²: a pair differs "
                             "from its one-pair launch")
                    worst[f"conv3x3 B={b} {dtype} {direction} "
                          f"{k_in}->{k_out} {hw}²"] = rel
                    if dtype == "bfloat16":
                        row = dict(timed[key], max_abs_err=pair_errors(
                            got, ref)[0], rel_err=rel, timed_with_row=True)
                        emit(row)
                        rows.append(row)
                    if not rel <= tol:
                        fail("kernels", f"conv3x3 B={b} {dtype} {direction}"
                             f" {k_in}->{k_out} at {hw}²: rel err {rel} > "
                             f"{tol}")
                    continue
                row = batched_row(
                    "conv3x3", [k_in, k_out, hw, hw], b, None, dtype, True,
                    got, ref, tol, lambda: cc.conv3x3_same(a, wp),
                    lambda: [cc.conv3x3_same(a[i], wp) for i in range(b)],
                    lambda: cc.conv3x3_plain(a, w_),
                    b * (k_in + k_out) * hw * hw * isz
                    + 9 * k_in * k_out * isz,
                    2.0 * b * 9 * k_in * k_out * hw * hw, lib, lib_name,
                    direction=direction,
                    plan=cc.conv_plan(k_in, k_out, hw, hw, b))
                timed[key] = row
                rows.append(row)
            del x, wt, g, ft, got, ref
            torch.cuda.empty_cache()
    for b_, c, p, k, dtype in BATCH_WBWD_EDGES:
        cdt = getattr(torch, dtype)
        f, _, m2, s = batched_input("gram", b_, c, p, k, cdt, dev, gen)
        ref = gp.gram_wbwd_plain(f, m2, s)
        got = gp.gram_wbwd(f, m2, s)
        rel = pair_errors(got, ref)[1]
        tol = max(out_tol(ref[i], dtype) for i in range(b_))
        key = f"gram_wbwd B={b_} {dtype} {c}x{p} K={k}"
        worst[key] = rel
        if not rel <= tol:
            fail("kernels", f"{key}: rel err {rel} > {tol}")
        if not pairs_equal_alone(got, [gp.gram_wbwd(f[i], m2[i], s[i])
                                       for i in range(b_)]):
            fail("kernels", f"{key}: a pair differs from its one-pair "
                 "launch")
    for b_, cin, cout, h, w, dtype in BATCH_CONV_EDGES:
        cdt = getattr(torch, dtype)
        x = torch.randn((b_, cin, h, w), generator=gen, device=dev).to(cdt)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              * math.sqrt(2.0 / (9 * cin))).to(cdt)
        ref = cc.conv3x3_plain(x, wt)
        wp = cc.pack_weights(wt)
        got = cc.conv3x3_same(x, wp)
        rel = pair_errors(got, ref)[1]
        if not pairs_equal_alone(got, [cc.conv3x3_same(x[i], wp)
                                       for i in range(b_)]):
            fail("kernels", f"conv3x3 B={b_} {dtype} {cin}->{cout} {h}x{w}: "
                 "a pair differs from its one-pair launch")
        tol = max(out_tol(ref[i], dtype) for i in range(b_))
        plan = (cc.conv_plan(cin, cout, h, w, b_) if dtype == "bfloat16"
                else None)
        key = f"conv3x3 B={b_} {dtype} {cin}->{cout} {h}x{w} plan {plan}"
        worst[key] = rel
        if not rel <= tol:
            fail("kernels", f"{key}: rel err {rel} > {tol}")
    emit({"phase": "kernel", "name": "batched gram_wbwd, conv3x3: fp32 "
          "and edges", "rel_err": worst})
    return rows


def check_batched_edges(dev, gen) -> None:
    """The batched kernels against their plain versions pair by pair where
    the plans split P or the reduction across blocks of a pair (fewer
    pairs), on the fp32 tiles, at ragged C and P, K = 1, 3, 5 and 9, on
    `gram_relu_bwd`'s other body (gram_wbwd's, past 64 channels or 8
    classes) and `lap_matvec` at odd sizes and with stats shared."""
    from dpst_tpu_torch.ops import gram_s2d as g2
    from dpst_tpu_torch.ops import gram_stream as gs
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    worst = {}
    for b, c, p, k, dtype in BATCH_EDGE_CASES:
        cdt = getattr(torch, dtype)
        f, _, m2, s = batched_input("gram", b, c, p, k, cdt, dev, gen)
        z, bias, rm2, rs = batched_input("relu", b, c, p, k, cdt, dev, gen)
        bf = dtype == "bfloat16"
        checks = (
            ("gram_fwd", gs.gram_fwd(f, m2), gs.gram_fwd_plain(f, m2), 1e-3,
             lambda i: gs.gram_fwd(f[i], m2[i])),
            ("gram_bwd", gs.gram_bwd(f, m2, s), gs.gram_bwd_plain(f, m2, s),
             1e-2 if bf else 1e-4, lambda i: gs.gram_bwd(f[i], m2[i], s[i])),
            ("gram_relu_fwd", g2.gram_relu_fwd(z, bias, rm2),
             g2.gram_relu_fwd_plain(z, bias, rm2), 1e-3,
             lambda i: g2.gram_relu_fwd(z[i], bias, rm2[i])),
            ("gram_relu_bwd", g2.gram_relu_bwd(z, bias, rm2, rs),
             ref := g2.gram_relu_bwd_plain(z, bias, rm2, rs),
             max(out_tol(ref[i], dtype) for i in range(b)) if bf else 1e-4,
             lambda i: g2.gram_relu_bwd(z[i], bias, rm2[i], rs[i])))
        for name, got, want, tol, one in checks:
            rel = pair_errors(got, want)[1]
            key = f"{name} B={b} {dtype} {c}x{p} K={k}"
            worst[key] = rel
            if not rel <= tol:
                fail("kernels", f"{key}: rel err {rel} > {tol}")
            if not pairs_equal_alone(got, [one(i) for i in range(b)]):
                fail("kernels", f"{key}: a pair differs from its one-pair "
                     "launch")
    for b, h, w, share in ((3, 37, 53, False), (2, 5, 700, False),
                           (4, 64, 61, True)):
        img = torch.rand((b, h, w, 3), generator=gen, device=dev)
        packed = torch.stack([lapc.pack_stats(lap.precompute_stats(i))
                              for i in img])
        if share:
            packed = packed[:1].expand(b, -1, -1, -1)
        v3 = torch.rand((b, 3, h, w), generator=gen, device=dev)
        rel = pair_errors(lapc.lap_matvec(packed, v3),
                          lapc.lap_matvec_plain(packed, v3))[1]
        key = f"lap_matvec B={b} {h}x{w}" + (" shared" if share else "")
        worst[key] = rel
        if not rel <= 1e-5:
            fail("kernels", f"{key}: rel err {rel} > 1e-5")
    emit({"phase": "kernel", "name": "batched edges", "rel_err": worst})


def batch_masks(b: int, size: int = SIZE, k: int = K):
    """K band masks of each of b pairs, distinct per pair: pair i's content
    bands run across the rows and its style bands across the columns, both
    moved on by i·size/(k·b) pixels (cyclically), so that no two pairs
    share a mask (a kernel that read another pair's masks would show)."""
    cm = np.zeros((b, k, size, size), np.float32)
    sm = np.zeros((b, k, size, size), np.float32)
    band = size // k
    for i in range(b):
        cls = (np.arange(size) + i * band // b) % size // band
        for j in range(k):
            cm[i, j, cls == j, :] = 1
            sm[i, j, :, cls == j] = 1
    return cm, sm


def batch_launches(steps: int) -> dict:
    """What the batch path launches at 512², K = 4, for `steps` Adam steps
    of all pairs: one pair's count (the batch's kernels launch once for all
    pairs). Its resolved config (s2d_gram="pallas") puts conv1_1 on the
    fused pair, one each a step; conv2_1 … conv5_1 on gram_fwd / gram_bwd;
    four pool backwards; one Laplacian matvec; the 13 convs' bias+ReLU
    each way; and the precompute's five style Grams, batched (gram_fwd),
    and bias+ReLU of 10 + 13 convs."""
    from dpst_tpu_torch.ops import kernels
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(lap_matvec=steps, gram_fwd=4 * steps + 5,
                gram_bwd=4 * steps, gram_relu_fwd=steps,
                gram_relu_bwd=steps, pool_bwd=4 * steps,
                bias_relu_fwd=13 * steps + 23, bias_relu_bwd=13 * steps)
    return need


def profile_batch(run, steps: int) -> dict:
    """Device ms per step by kernel group of `run()` (which takes `steps`
    steps) under torch.profiler, and their sum."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    for ev in prof.events():
        if on_device(ev):
            g = kernel_group(ev.name)
            groups[g] = (groups.get(g, 0.0)
                         + ev.time_range.elapsed_us() / 1e3 / steps)
    if not groups:
        fail("profile", "torch.profiler recorded no device time")
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def run_batch_path(dev, gen, smi: str) -> dict:
    """The eighth path: `stylize_batch` of BATCH distinct seeded 512² pairs
    with K = 4 distinct band masks each (`batch_masks`), PRESETS["config3"]
    for BATCH_ITERS of its 500 steps: counters reset just before and read
    just after, held to one pair's count (`batch_launches`); the loss falls
    for every pair, the output is finite in [0, 255]; each pair's history
    and image against the same pair run alone through `stylize` (under the
    batch's resolved config) within BATCH_HIST_TOL and BATCH_PIXEL_TOL
    (bf16: cuDNN chooses its conv algorithms per batch size); a rerun of
    RERUN_ITERS steps bit for bit. Measures the precompute seconds (warm),
    the loop's pair-it/s (BATCH_ITERS steps after a warm-up, timed as one
    segment), device ms per step by kernel group, the busy share and the
    peak memory. Returns (the launches, the run's inputs and outputs for
    the spatial phase's mesh batch)."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import batch as pb

    label = f"config3 batch B={BATCH} 512²"
    contents = torch.stack([smooth_image(gen, dev, SIZE)
                            for _ in range(BATCH)]).cpu().numpy()
    styles = torch.stack([textured_image(gen, dev, SIZE)
                          for _ in range(BATCH)]).cpu().numpy()
    cm, sm = batch_masks(BATCH)
    params = vgg.get_params(seed=SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              iterations=BATCH_ITERS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    images, hist = dpst_tpu_torch.stylize_batch(contents, styles, cm, sm,
                                                cfg, vgg_params=params)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the precompute alone (warm), then the loop as one timed segment
    rcfg = pb.resolve_config(cfg)
    pp = vgg.pack_params(params, rcfg.compute_dtype, rcfg.conv_impl)
    batch = [torch.from_numpy(a).to(dev) for a in (contents, styles, cm, sm)]
    weights = optimize.LossWeights.from_config(rcfg)
    pb.prepare_batch_stage(*batch, pp, (SIZE, SIZE), rcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    consts, cs, means = pb.prepare_batch_stage(*batch, pp, (SIZE, SIZE),
                                               rcfg)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    img0 = optimize.init_image(rcfg, cs, means)
    pb.run_batch(img0, consts, weights, pp, rcfg, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb.run_batch(img0, consts, weights, pp, rcfg, BATCH_ITERS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = loop_s * 1e3 / BATCH_ITERS
    groups = profile_batch(
        lambda: pb.run_batch(img0, consts, weights, pp, rcfg, 10), 10)
    busy = sum(groups.values())
    emit({"phase": "profile", "path": label, "steps": 10,
          "device_ms_per_step": groups, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms})

    # each pair alone through stylize, under the batch's resolved config
    alone_err = []
    for i in range(BATCH):
        out_i, hist_i = dpst_tpu_torch.stylize(
            contents[i], styles[i], rcfg, content_masks=cm[i],
            style_masks=sm[i], vgg_params=params, return_history=True)
        d = np.abs(images[i] - out_i)
        rel = np.abs(hist[i] - hist_i) / np.maximum(
            np.abs(hist_i).max(axis=0), 1e-30)
        alone_err.append({
            "row0_rel": float(rel[0].max()), "hist_rel": float(rel.max()),
            "pixel_max": float(d.max()), "pixel_mean": float(d.mean()),
            "bit_equal": bool(np.array_equal(images[i], out_i))})
    _, hist2 = dpst_tpu_torch.stylize_batch(
        contents, styles, cm, sm, dataclasses.replace(
            cfg, iterations=RERUN_ITERS), vgg_params=params)
    identical = bool(np.array_equal(hist2, hist[:, :RERUN_ITERS]))
    emit({"phase": "batch", "path": label, "B": BATCH, "size": SIZE,
          "K": K, "iterations": BATCH_ITERS, "preset_iterations": 500,
          "compute_dtype": cfg.compute_dtype, "s2d_gram": rcfg.s2d_gram,
          "weights": weights_label(),
          "wall_s": wall_s, "precompute_s": precompute_s,
          "loop_it_s": BATCH_ITERS / loop_s,
          "pair_it_s": BATCH * BATCH_ITERS / loop_s,
          "projected_500_steps_s_per_pair": (
              precompute_s + 500 * loop_s / BATCH_ITERS) / BATCH,
          "max_memory_gb": peak, "launches": launches,
          "first_rows": hist[:, 0].tolist(), "last_rows": hist[:, -1].tolist(),
          "vs_alone": alone_err, "row0_tol_rel": BATCH_ROW0_TOL,
          "hist_tol_rel": BATCH_HIST_TOL, "pixel_tol": BATCH_PIXEL_TOL,
          "batch_vs_one_at_step_0": batch_rounding(consts, img0, weights,
                                                   pp, rcfg),
          "rerun_bit_identical": identical, "nvidia_smi": smi})
    bad = [f"{name} launched {launches[name]} times, one pair's "
           f"{BATCH_ITERS} steps imply {n}"
           for name, n in batch_launches(BATCH_ITERS).items()
           if launches[name] != n]
    if not (hist[:, -1, 0] < hist[:, 0, 0]).all():
        bad.append("the total loss did not fall for every pair")
    if not hist[:, :, 3].min() >= -1.0:
        bad.append(f"photoreal term {hist[:, :, 3].min()} < -1")
    if not (images.shape == (BATCH, SIZE, SIZE, 3)
            and np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 255.0):
        bad.append("output not finite (B, 512, 512, 3) in [0, 255]")
    for i, e in enumerate(alone_err):
        if not (e["row0_rel"] <= BATCH_ROW0_TOL
                and e["hist_rel"] <= BATCH_HIST_TOL
                and e["pixel_mean"] <= BATCH_PIXEL_TOL):
            bad.append(f"pair {i} against its run alone: {e}")
    if not identical:
        bad.append("the rerun's history differs")
    if bad:
        fail("batch", f"{label}: " + "; ".join(bad))
    run_batch_reference(gen)
    return launches, dict(contents=contents, styles=styles, cm=cm, sm=sm,
                          params=params, cfg=cfg, images=images, hist=hist)


def batch_inputs(b: dict, dev) -> list:
    return [torch.from_numpy(b[k]).to(dev)
            for k in ("contents", "styles", "cm", "sm")]


def run_batch_pallas(dev, b: dict, smi: str) -> dict:
    """`stylize_batch` of the batch phase's BATCH pairs under
    PRESETS["config3"] with conv_impl="pallas", gram_impl="pallas" (the
    pallas route: `conv3x3` and `gram_wbwd` with their batch grid
    dimension) for BATCH_PALLAS_ITERS steps: counters reset just before
    and read just after, equal to one pair's run of the route
    (`pallas_route_launches`); the loss falls for every pair, the output
    finite in [0, 255]; each pair against its run alone within
    BATCH_ROW0_TOL, BATCH_HIST_TOL and BATCH_PIXEL_TOL; the loop's
    pair-it/s (timed as one segment after a warm-up), device ms a step by
    group and the busy share."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import batch as pb
    label = f"config3 pallas route batch B={BATCH} 512²"
    steps = BATCH_PALLAS_ITERS
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              conv_impl="pallas", gram_impl="pallas",
                              iterations=steps)
    kernels.reset_launches()
    images, hist = dpst_tpu_torch.stylize_batch(
        b["contents"], b["styles"], b["cm"], b["sm"], cfg,
        vgg_params=b["params"])
    launches = dict(kernels.LAUNCHES)
    rcfg = pb.resolve_config(cfg)
    pp = vgg.pack_params(b["params"], rcfg.compute_dtype, rcfg.conv_impl)
    weights = optimize.LossWeights.from_config(rcfg)
    consts, cs, means = pb.prepare_batch_stage(
        *batch_inputs(b, dev), pp, (SIZE, SIZE), rcfg)
    img0 = optimize.init_image(rcfg, cs, means)
    pb.run_batch(img0, consts, weights, pp, rcfg, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb.run_batch(img0, consts, weights, pp, rcfg, steps)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = loop_s * 1e3 / steps
    groups = profile_batch(
        lambda: pb.run_batch(img0, consts, weights, pp, rcfg, 5), 5)
    busy = sum(groups.values())
    del consts, cs, means, img0
    torch.cuda.empty_cache()
    alone = []
    for i in range(BATCH):
        out_i, hist_i = dpst_tpu_torch.stylize(
            b["contents"][i], b["styles"][i], rcfg,
            content_masks=b["cm"][i], style_masks=b["sm"][i],
            vgg_params=b["params"], return_history=True)
        d = np.abs(images[i] - out_i)
        rel = np.abs(hist[i] - hist_i) / np.maximum(
            np.abs(hist_i).max(axis=0), 1e-30)
        alone.append({"row0_rel": float(rel[0].max()),
                      "hist_rel": float(rel.max()),
                      "pixel_max": float(d.max()),
                      "pixel_mean": float(d.mean())})
    need = pallas_route_launches(steps)
    emit({"phase": "batch", "path": label, "B": BATCH, "size": SIZE, "K": K,
          "iterations": steps, "compute_dtype": cfg.compute_dtype,
          "weights": weights_label(), "loop_it_s": steps / loop_s,
          "pair_it_s": BATCH * steps / loop_s, "step_ms": step_ms,
          "device_ms_per_step": groups, "device_busy_ms_per_step": busy,
          "device_busy_share": busy / step_ms, "launches": launches,
          "launches_expected": need, "vs_alone": alone,
          "row0_tol_rel": BATCH_ROW0_TOL, "hist_tol_rel": BATCH_HIST_TOL,
          "pixel_tol": BATCH_PIXEL_TOL, "nvidia_smi": smi})
    bad = [f"{k} launched {launches[k]} times, one pair's route implies {n}"
           for k, n in need.items() if launches[k] != n]
    if not (hist[:, -1, 0] < hist[:, 0, 0]).all():
        bad.append("the total loss did not fall for every pair")
    if not (np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 255.0):
        bad.append("output not finite in [0, 255]")
    for i, e in enumerate(alone):
        if not (e["row0_rel"] <= BATCH_ROW0_TOL
                and e["hist_rel"] <= BATCH_HIST_TOL
                and e["pixel_mean"] <= BATCH_PIXEL_TOL):
            bad.append(f"pair {i} against its run alone: {e}")
    if bad:
        fail("batch", f"{label}: " + "; ".join(bad))
    return launches


def lbfgs_batch_vs_alone(b: dict, cfg) -> tuple:
    """`stylize_batch` of the pairs `b` under `cfg` (L-BFGS) and each pair
    alone through `stylize` under the batch's resolved config: (images,
    history, the record, the launches of the batch's run, each pair's
    `lbfgs_trajectory_errors` against its run alone with
    "evaluation_steps_apart" and "bit_equal")."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import batch as pb
    with optimize.record_evaluations() as rec:
        kernels.reset_launches()
        images, hist = dpst_tpu_torch.stylize_batch(
            b["contents"], b["styles"], b["cm"], b["sm"], cfg,
            vgg_params=b["params"])
        launches = dict(kernels.LAUNCHES)
    counts = np.asarray([[p["evaluations"] for p in r["pairs"]]
                         for r in rec]).T          # (B, steps)
    rcfg = pb.resolve_config(cfg)
    alone = []
    for i in range(len(images)):
        with optimize.record_evaluations() as rec_i:
            out_i, hist_i = dpst_tpu_torch.stylize(
                b["contents"][i], b["styles"][i], rcfg,
                content_masks=b["cm"][i], style_masks=b["sm"][i],
                vgg_params=b["params"], return_history=True)
        e = lbfgs_trajectory_errors(images[i], hist[i], out_i, hist_i)
        e["evaluation_steps_apart"] = int(np.abs(
            counts[i] - np.asarray([r["evaluations"] for r in rec_i]))
            .max())
        e["bit_equal"] = bool(np.array_equal(hist[i], hist_i)
                              and np.array_equal(images[i], out_i))
        alone.append(e)
    return images, hist, rec, launches, alone


def run_batch_lbfgs(dev, b: dict, smi: str) -> dict:
    """`stylize_batch` of the batch phase's BATCH pairs under
    PRESETS["config3"] with optimizer="lbfgs" for BATCH_LBFGS_ITERS steps:
    the pairs as one batched loop (each pair's own memory and zoom
    linesearch, the searches in lockstep, one batched evaluation a round).
    Counters reset just before and read just after, equal to one pair's
    launches an evaluation × the batched evaluations E (`batch_launches`
    of E steps); the loss falls for every pair; a rerun bit
    for bit; each pair against its one-pair L-BFGS run (`stylize` under
    the batch's resolved config) with evaluation counts within ±2 a step:
    in bf16 (the preset) the first row within BATCH_ROW0_TOL, the first
    ten rows, SSIM and all rows within the L-BFGS golden's bounds; in fp32
    (the same pairs and steps, compute_dtype="float32") within all of the
    golden's bounds. (Every batched kernel splits a pair's sums as one
    pair's plan does, so a batch's bf16 rounds apart from one pair's only
    where cuDNN's bf16 convs choose by batch size; fp32 rounds apart by
    fp32 ulps.) Then the loop
    alone: evaluations/s and pair-evaluations/s, device ms of an
    evaluation by group and its busy share, and the synchronizing
    operations of one step (torch's sync debug mode): one for all pairs an
    evaluation, and one copy of the history."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import batch as pb
    label = f"config3 L-BFGS batch B={BATCH} 512²"
    steps = BATCH_LBFGS_ITERS
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs", iterations=steps)
    images, hist, rec, launches, alone = lbfgs_batch_vs_alone(b, cfg)
    with optimize.record_evaluations() as rec2:
        images2, hist2 = dpst_tpu_torch.stylize_batch(
            b["contents"], b["styles"], b["cm"], b["sm"], cfg,
            vgg_params=b["params"])
    ev = lbfgs_evaluations(rec)
    counts = [[p["evaluations"] for p in r["pairs"]] for r in rec]
    identical = bool(np.array_equal(hist, hist2)
                     and np.array_equal(images, images2)
                     and [r["evaluations"] for r in rec]
                     == [r["evaluations"] for r in rec2])
    _, _, _, _, alone32 = lbfgs_batch_vs_alone(b, dataclasses.replace(
        cfg, compute_dtype="float32"))
    rcfg = pb.resolve_config(cfg)
    # the loop alone on the batch's constants
    pp = vgg.pack_params(b["params"], rcfg.compute_dtype, rcfg.conv_impl)
    weights = optimize.LossWeights.from_config(rcfg)
    consts, cs, means = pb.prepare_batch_stage(
        *batch_inputs(b, dev), pp, (SIZE, SIZE), rcfg)
    img0 = optimize.init_image(rcfg, cs, means)
    seg = lambda n: pb.run_batch(img0, consts, weights, pp, rcfg, n)
    seg(2)
    torch.cuda.synchronize()
    with optimize.record_evaluations() as rec_t:
        t0 = time.perf_counter()
        seg(steps)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    e_t = lbfgs_evaluations(rec_t)["E"]
    pair_evals = sum(p["evaluations"] for r in rec_t for p in r["pairs"])
    with optimize.record_evaluations() as rec_s:
        _, syncs, sync_sites = count_syncs(lambda: seg(1))
    e_s = lbfgs_evaluations(rec_s)["E"]
    with optimize.record_evaluations() as rec_p:
        groups = profile_batch(lambda: seg(2), 1)
    e_p = lbfgs_evaluations(rec_p)["E"]
    groups = {g: ms / e_p for g, ms in groups.items()}
    busy = sum(groups.values())
    eval_ms = loop_s * 1e3 / e_t
    del consts, cs, means, img0
    torch.cuda.empty_cache()
    # an evaluation launches what an Adam step of the batch does
    need = batch_launches(ev["E"])
    emit({"phase": "batch", "path": label, "B": BATCH, "size": SIZE, "K": K,
          "iterations": steps, "compute_dtype": cfg.compute_dtype,
          "weights": weights_label(), "evaluations": ev["E"],
          "evaluations_per_step": ev["per_step"],
          "pair_evaluations_per_step": np.asarray(counts).T.tolist(),
          "safe_steps": ev["safe_steps"], "loop_s": loop_s,
          "loop_evaluations": e_t, "evaluations_per_s": e_t / loop_s,
          "pair_evaluations_per_s": BATCH * e_t / loop_s,
          "searched_pair_evaluations_per_s": pair_evals / loop_s,
          "steps_per_s": steps / loop_s, "pair_steps_per_s":
          BATCH * steps / loop_s, "evaluation_ms_unprofiled": eval_ms,
          "device_ms_per_evaluation": groups,
          "device_busy_ms_per_evaluation": busy,
          "device_busy_share": busy / eval_ms,
          "syncs_one_step": syncs, "evaluations_one_step": e_s,
          "sync_sites": sync_sites, "launches": launches,
          "launches_expected": need, "vs_alone": alone,
          "fp32_vs_alone": alone32,
          "tol": {"bf16": {"ssim_min": LBFGS_SSIM_MIN,
                           "row0": BATCH_ROW0_TOL,
                           "rows 0-9": LBFGS_HIST10_RTOL,
                           "all": LBFGS_HIST_RTOL},
                  "fp32": {"ssim_min": LBFGS_SSIM_MIN,
                           "row0": LBFGS_ROW0_TOL,
                           "rows 0-9": LBFGS_HIST10_RTOL,
                           "all": LBFGS_HIST_RTOL},
                  "evaluations": 2},
          "rerun_bit_identical": identical, "nvidia_smi": smi})
    bad = [f"{k} launched {launches[k]} times, E = {ev['E']} implies {n}"
           for k, n in need.items() if launches[k] != n]
    if ev["fresh"] != ev["fresh_expected"]:
        bad.append(f"{ev['fresh']} fresh evaluations, optax's rule implies "
                   f"{ev['fresh_expected']}")
    if not (hist[:, -1, 0] < hist[:, 0, 0]).all():
        bad.append("the total loss did not fall for every pair")
    if not (np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 255.0):
        bad.append("output not finite in [0, 255]")
    for i, (e, e32) in enumerate(zip(alone, alone32)):
        rel = np.asarray(e["rel_err_per_row"])
        if not (e["ssim"] >= LBFGS_SSIM_MIN and rel[0] <= BATCH_ROW0_TOL
                and rel[:10].max() <= LBFGS_HIST10_RTOL
                and rel.max() <= LBFGS_HIST_RTOL):
            bad.append(f"pair {i} against its run alone, bf16: {e}")
        bad += [f"pair {i} against its run alone, fp32: {x}"
                for x in lbfgs_bounds_bad(e32, LBFGS_ROW0_TOL)]
        if not max(e["evaluation_steps_apart"],
                   e32["evaluation_steps_apart"]) <= 2:
            bad.append(f"pair {i}: evaluation counts differ by more than 2")
    if not identical:
        bad.append("the rerun is not bit-identical")
    # one fetch of the pairs' values and slopes a batched evaluation, and
    # one copy of the segment's history to the device
    if not e_s <= syncs <= e_s + 1:
        bad.append(f"{syncs} synchronizing operations for {e_s} batched "
                   f"evaluations")
    if bad:
        fail("batch", f"{label}: " + "; ".join(bad))
    return launches


def batch_rounding(consts, image: torch.Tensor, weights, params: dict,
                   cfg) -> dict:
    """Where a batch's first step and one pair's part, op by op: pair 0 of
    the batch against the same pair as a batch of one, max |difference|
    over max |value| (0: bit-equal) of the bf16 VGG taps (cuDNN's
    forward), each tap's masked Grams (gram_fwd on the batch's plan, or
    the fused pair at conv1_1), the loss terms, and the input gradient
    (cuDNN's backward, the Gram backwards, the reductions)."""
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import losses
    one = consts.map(lambda t: t[:1])
    layers = cfg.style_layers
    out = {}
    with torch.no_grad():
        both = vgg.extract_features(params, image, layers,
                                    compute_dtype=cfg.compute_dtype)
        alone = vgg.extract_features(params, image[:1], layers,
                                     compute_dtype=cfg.compute_dtype)
        for l in layers:
            out[f"tap {l}"] = rel_err(both[l][0], alone[l][0])[1]
            gb = losses.masked_grams(both[l], consts.masks[l],
                                     compute_dtype=cfg.compute_dtype)
            g1 = losses.masked_grams(alone[l], one.masks[l],
                                     compute_dtype=cfg.compute_dtype)
            out[f"Grams {l}"] = rel_err(gb[0], g1[0])[1]
    loss = optimize.make_loss_fn(cfg)
    grads = []
    for img, c in ((image, consts), (image[:1], one)):
        x = img.detach().requires_grad_(True)
        total, terms = loss(x, c, weights, params)
        grads.append((torch.autograd.grad(total, x)[0][0],
                      terms[0].detach()))
    for j, name in enumerate(("total", "content", "style", "photoreal")):
        out[f"loss {name}"] = rel_err(grads[0][1][j:j + 1],
                                      grads[1][1][j:j + 1])[1]
    out["input gradient"] = rel_err(grads[0][0], grads[1][0])[1]
    return out


def run_batch_reference(gen, size: int = 64, b: int = 2) -> None:
    """An fp32 `stylize_batch` of b distinct 64² pairs (3 distinct stripe
    masks each) on the card against the same batch on the CPU, where every
    kernel wrapper takes its plain version: each pair's history rows within
    1e-3 of the CPU's (of each column's max), as the one-pair reference."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    contents = torch.stack([smooth_image(gen, gen.device, size)
                            for _ in range(b)]).cpu().numpy()
    styles = torch.stack([smooth_image(gen, gen.device, size)
                          for _ in range(b)]).cpu().numpy()
    cm, sm = batch_masks(b, size, 3)
    cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32", iterations=5,
                                       regularization_weight=100.0,
                                       block1_impl="s2d")
    params = vgg.init_params(SEED)
    hists = {where: dpst_tpu_torch.stylize_batch(
        contents, styles, cm, sm, cfg, vgg_params=params, device=where)[1]
        for where in ("cuda", "cpu")}
    rel = np.abs(hists["cuda"] - hists["cpu"]) / np.maximum(
        np.abs(hists["cpu"]).max(axis=1, keepdims=True), 1e-30)
    worst, tol = float(rel.max()), 1e-3
    emit({"phase": "reference", "path": f"config3 batch B={b}", "size": size,
          "K": 3, "iterations": 5, "compute_dtype": "float32",
          "max_rel_err_vs_cpu": worst, "tol_rel": tol})
    if not worst <= tol:
        fail("reference", f"batch B={b}: card vs CPU history rel err "
             f"{worst} > {tol}")


def virtual_rows(dev, n: int):
    """A row mesh of n shards, every one on `dev`: a virtual mesh (one card
    standing for n devices, as the JAX tests' virtual CPU devices do)."""
    from dpst_tpu_torch.parallel import spatial as sp
    return sp.make_spatial_mesh(devices=[dev] * n)


def spatial_launches(plan: tuple, n: int, steps: int) -> dict:
    """What `stylize_spatial` of PRESETS["config3"] launches for `steps`
    Adam steps over n row shards under the level plan `plan`: n × the
    one-device count at a sharded level, the one-device count at a
    gathered one. A step: the five style taps' Grams (conv{b}_1 at level
    b-1: gram_fwd and gram_bwd), the four pool backwards (pool b on level
    b's shards, or whole where level b is gathered), the Laplacian on every
    shard (level 0), the bias+ReLU of each conv each way (level b-1 holds
    block b's convs: 2, 2, 4, 4 and conv5_1); the precompute (on the first
    device, unsharded): the five style Grams (gram_fwd) and bias+ReLU of
    10 + 13 convs."""
    from dpst_tpu_torch.ops import kernels
    per = [n if sharded else 1 for sharded in plan]
    relus = steps * sum(c * k for c, k in zip((2, 2, 4, 4, 1), per))
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(gram_fwd=5 + steps * sum(per), gram_bwd=steps * sum(per),
                pool_bwd=steps * sum(per[1:]), lap_matvec=steps * n,
                bias_relu_fwd=23 + relus, bias_relu_bwd=relus)
    return need


def profile_spatial(run, steps: int) -> dict:
    """`profile_batch` of `run()`, with the device time of the kernels that
    the halo exchanges and level gathers launch (the CPU ops under the
    `laplacian_spmd.HALO_RANGE` range: their concatenations and zero rows;
    on a virtual mesh `.to(device)` copies nothing) moved into a group of
    their own, "halo copies (forward)". Their backward (narrowed views and
    the additions of the halo rows' gradients into the neighbours') stays
    in "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dpst_tpu_torch.ops.laplacian_spmd import HALO_RANGE
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    for ev in prof.events():
        if on_device(ev):
            g = kernel_group(ev.name)
            groups[g] = (groups.get(g, 0.0)
                         + ev.time_range.elapsed_us() / 1e3 / steps)
    halo = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        p = ev.cpu_parent
        while p is not None and p.name != HALO_RANGE:
            p = p.cpu_parent
        if p is None:
            continue
        for k in ev.kernels:
            ms = k.duration / 1e3 / steps
            halo += ms
            groups[kernel_group(k.name)] -= ms
    if not groups:
        fail("profile", "torch.profiler recorded no device time")
    groups["halo copies (forward)"] = halo
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def check_matvec_spmd(dev, n: int = 4) -> dict:
    """`matvec_spmd` over a virtual row mesh of n shards against the
    one-device `lap_matvec` at each of SPMD_SIZES, fp32: expected bit-equal
    (each output value has the same operands in the same order), held to
    lap_matvec's 1e-5 of max|y|, and against the plain version on the
    same halo-extended shards (1e-5); n launches a call; back-to-back event
    time (`cuda_ms`; at 512² the host's launch rate sets it) of the loop's
    form (`local_matvec`: the v exchange and a launch a shard, the stats'
    halos made once) in turns with the one-device launch, and of the whole
    `matvec_spmd` (global in, global out: the stats exchanged too) and of
    `AmbientMatvec` under `use_mesh` (the stats' halos kept; bit-equal to
    the sharded result).
    Raises its "local rows" and "ambient mesh" errors. Returns the
    `kernels` line's "lap_matvec spmd" entry (the 4096² row) without its
    launches."""
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    from dpst_tpu_torch.ops import laplacian_spmd as ls
    from dpst_tpu_torch.parallel import mesh as ml
    mesh = virtual_rows(dev, n)
    devs = [dev] * n
    own = torch.Generator(device=dev).manual_seed(SEED + 30)
    row = None
    for size in SPMD_SIZES:
        img = torch.rand((size, size, 3), generator=own, device=dev)
        packed = lapc.pack_stats(lap.precompute_stats(img))
        v3 = torch.rand((3, size, size), generator=own, device=dev)
        ref = lapc.lap_matvec(packed, v3)
        before = kernels.LAUNCHES["lap_matvec"]
        y = ls.matvec_spmd(packed, v3.permute(1, 2, 0), mesh=mesh)
        launches = kernels.LAUNCHES["lap_matvec"] - before
        y = y.permute(2, 0, 1)
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        ext = ls.exchange_rows(ls.split_rows(packed, devs))
        vs = ls.split_rows(v3, devs)
        # the plain version on the same halo-extended shards, cropped
        plain = torch.cat([
            lapc.lap_matvec_plain(s, v)[..., ls.HALO:-ls.HALO, :]
            for s, v in zip(ext, ls.exchange_rows(vs))], dim=-2)
        plain_rel = rel_err(y, plain)[1]
        del plain
        local = lambda: ls.local_matvec(ext, vs)
        one = lambda: lapc.lap_matvec(packed, v3)
        # back-to-back event times, in turns: the card's profiler drops
        # events of these traces (a trace of 120 came 118 in every attempt;
        # the sum of what came once halved the one-device launch), and at
        # 4096² the device, not the host, sets the event time
        k1, o1, o2, k2 = (cuda_ms(local), cuda_ms(one), cuda_ms(one),
                          cuda_ms(local))
        vhwc = v3.permute(1, 2, 0)
        # laplacian_impl="spmd"'s matvec inside use_mesh: the stats' shards
        # and halos made on its first call and kept
        amb = ls.AmbientMatvec()
        with ml.use_mesh(mesh):
            amb_equal = bool(torch.equal(amb(packed, v3), y))
            amb_ms = cuda_ms(lambda: amb(packed, v3))
        b, by = bound_ms(20 * size * size * 4,
                         LAP_OPS_PER_PIXEL * size * size, "float32")
        row = {"phase": "spatial", "check": "matvec_spmd",
               "mesh": f"virtual: {n} row shards on one card",
               "shape": [3, size, size], "dtype": "float32",
               "launches_a_call": launches, "bit_equal": bool(torch.equal(
                   y, ref)), "max_abs_err": err, "rel_err": rel,
               "tol_rel": 1e-5, "rel_err_vs_plain_on_shards": plain_rel,
               "ms": (k1 + k2) / 2,
               "one_device_ms": (o1 + o2) / 2,
               "matvec_spmd_ms": cuda_ms(
                   lambda: ls.matvec_spmd(packed, vhwc, mesh=mesh)),
               "ambient_ms": amb_ms, "ambient_bit_equal": amb_equal,
               "plain_ms": cuda_ms(lambda: [
                   lapc.lap_matvec_plain(s, v) for s, v in
                   zip(ext, ls.exchange_rows(vs))], warmup=1, iters=2),
               "bound_ms": b, "bound_by": by,
               "strip_rows_a_shard": lapc.lap_plan(size // n + 4, size)}
        emit(row)
        if not (rel <= 1e-5 and plain_rel <= 1e-5 and launches == n
                and amb_equal):
            fail("spatial", f"matvec_spmd {size}²: rel err {rel} against "
                 f"the unsharded kernel, {plain_rel} against the plain "
                 f"version on the shards, {launches} launches, ambient "
                 f"matvec bit-equal {amb_equal} (expected <= 1e-5, "
                 f"<= 1e-5, {n}, True)")
        del img, packed, v3, ref, y, ext, vs
        torch.cuda.empty_cache()
    small = torch.rand((8, 16, 3), generator=own, device=dev)
    packed = lapc.pack_stats(lap.precompute_stats(small))
    for kw, text in (({"mesh": virtual_rows(dev, 8)}, "local rows"),
                     ({}, "ambient mesh")):
        try:
            ls.matvec_spmd(packed, small, **kw)
        except ValueError as e:
            if text not in str(e):
                fail("spatial", f"matvec_spmd raised {e!r}, not {text!r}")
        else:
            fail("spatial", f"matvec_spmd did not raise {text!r}")
    emit({"phase": "spatial", "check": "matvec_spmd errors",
          "raised": ["local rows", "ambient mesh"]})
    return {"name": "lap_matvec spmd", "route": "cuda",
            "source": "dpst_tpu_torch/csrc/lap_matvec.cu",
            "replaces": "dpst_tpu/ops/laplacian_pallas.py:111",
            "also_replaces": "dpst_tpu/ops/laplacian_spmd.py:72",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "dtype": "float32", "shards": n,
            "mesh": f"virtual: {n} row shards on one card",
            "shape": row["shape"], "one_device_ms": row["one_device_ms"]}


def run_spatial(dev, gen, smi: str, batch_run: dict) -> tuple[dict, dict]:
    """The ninth path, the phase "spatial": `matvec_spmd` against the
    one-device kernel (`check_matvec_spmd`); `stylize_spatial` of
    PRESETS["config3"] with laplacian_impl="pallas" (→ "spmd") at SP_SIZE²
    on SP_SHARDS row shards of a virtual mesh (every shard on this one
    card), K = 4 band masks, SP_ITERS Adam steps, bf16: counters reset just
    before and read just after, equal to `spatial_launches` of the level
    plan; loop it/s, precompute seconds, peak memory, device ms a step by
    group with the halo copies apart, the first history row against a
    1-step unsharded run of the same resolved config (SP_ROW0_TOL), the
    bf16 Grams of every style tap, whole and sharded, against fp64
    (`spatial_gram_rounding`), `gram_fwd`, `gram_bwd` and `pool_bwd` at
    the shard shapes against their plain versions (`check_path_kernels`);
    at 512² bf16 10 steps sharded against unsharded (SP_HIST_TOL) and a
    bit-identical rerun; a 64² fp32 sharded run, card against CPU (1e-3);
    `stylize_batch` of the batch phase's 8 pairs over a virtual mesh of
    two, each pair against the batch phase's one-device run (the batch
    tolerances), counters; a 2 × 2 mesh batch and `autotune` over a mesh
    of two at 64² fp32, card against CPU; `run_spatial_lbfgs` and
    `run_spatial_lbfgs_small`. Returns ({path: its launches} of the Adam
    and L-BFGS paths at SP_SIZE², the `kernels` line's "lap_matvec spmd"
    entry)."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.ops.laplacian_spmd import HALO
    from dpst_tpu_torch.parallel import spatial as sp

    emit({"phase": "spatial", "device_count": torch.cuda.device_count(),
          "mesh": "virtual: every shard on cuda:0 (one card stands for "
                  "several devices; no cross-card time or memory)"})
    entry = check_matvec_spmd(dev, SP_SHARDS)

    n, size = SP_SHARDS, SP_SIZE
    label = (f"config3 spatial {size}², {n} row shards "
             f"(virtual mesh, one card)")
    content = smooth_image(gen, dev, size).cpu().numpy()
    style = textured_image(gen, dev, size).cpu().numpy()
    cm, sm = band_masks(K, size, 0, 0), band_masks(K, size, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              laplacian_impl="pallas", iterations=SP_ITERS)
    rcfg = cfg.spmd_safe()
    mesh = virtual_rows(dev, n)
    plan = sp.level_plan(size, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    img, hist = sp.stylize_spatial(content, style, cm, sm, cfg, params, mesh)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    img, hist = img.cpu().numpy(), hist.cpu().numpy()

    # the precompute alone (warm), then the loop as one timed segment
    pp = vgg.params_by_device(params, [dev], rcfg.compute_dtype,
                              rcfg.conv_impl)
    arrays = [torch.from_numpy(a).to(dev)[None]
              for a in (content, style, cm, sm)]
    dpst_tpu_torch.prepare_constants(*arrays, rcfg, pp[mesh.first])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    consts = dpst_tpu_torch.prepare_constants(*arrays, rcfg, pp[mesh.first])
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    sc, shards = sp.shard_spatial(consts, arrays[0].clone(), mesh)
    del consts
    weights = optimize.LossWeights.from_config(rcfg)
    seg = lambda steps: optimize.drain(sp.spatial_segment(
        shards, sc, weights, pp, steps, rcfg))
    seg(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg(SP_ITERS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = loop_s * 1e3 / SP_ITERS
    groups = profile_spatial(lambda: seg(SP_PROFILE_STEPS), SP_PROFILE_STEPS)
    busy = sum(groups.values())
    emit({"phase": "profile", "path": label, "steps": SP_PROFILE_STEPS,
          "device_ms_per_step": groups, "device_busy_ms_per_step": busy,
          "step_ms_unprofiled": step_ms, "device_busy_share": busy / step_ms})
    del sc, shards, arrays
    torch.cuda.empty_cache()

    spatial_gram_rounding(content, cm, pp[mesh.first], rcfg, n)
    torch.cuda.empty_cache()
    # the first row against one unsharded step of the same resolved config
    _, hist1 = dpst_tpu_torch.stylize(
        content, style, dataclasses.replace(rcfg, laplacian_impl="xla",
                                            iterations=1),
        content_masks=cm, style_masks=sm, vgg_params=params,
        return_history=True)
    # of each column's max over the sharded run's steps (the content term
    # is 0 at step 0 unsharded)
    row0 = np.abs(hist[0] - hist1[0]) / np.maximum(
        np.abs(hist).max(axis=0), 1e-30)
    need = spatial_launches(plan, n, SP_ITERS)
    emit({"phase": "spatial", "path": label, "size": size, "shards": n,
          "K": K, "iterations": SP_ITERS, "compute_dtype": cfg.compute_dtype,
          "laplacian_impl": rcfg.laplacian_impl, "level_plan": list(plan),
          "sharded_heights": [size >> l for l in range(5) if plan[l]],
          "gathered_heights": [size >> l for l in range(5) if not plan[l]],
          "weights": weights_label(),
          "wall_s": wall_s, "precompute_s": precompute_s,
          "loop_it_s": SP_ITERS / loop_s, "max_memory_gb": peak,
          "launches": launches, "launches_expected": need,
          "first_row": hist[0].tolist(), "last_row": hist[-1].tolist(),
          "unsharded_first_row": hist1[0].tolist(),
          "first_row_rel_err": row0.tolist(), "row0_tol_rel": SP_ROW0_TOL,
          "nvidia_smi": smi})
    bad = [f"{k} launched {launches[k]} times, the plan implies {v}"
           for k, v in need.items() if launches[k] != v]
    if not hist[-1, 0] < hist[0, 0]:
        bad.append(f"total loss did not fall: {hist[0, 0]} -> {hist[-1, 0]}")
    if not hist[:, 3].min() >= -1.0:
        bad.append(f"photoreal term {hist[:, 3].min()} < -1")
    if not (img.shape == (size, size, 3) and np.isfinite(img).all()
            and img.min() >= 0.0 and img.max() <= 255.0):
        bad.append("output not finite (H, W, 3) in [0, 255]")
    if not row0.max() <= SP_ROW0_TOL:
        bad.append(f"first row {row0.tolist()} from the unsharded step")
    if bad:
        fail("spatial", f"{label}: " + "; ".join(bad))
    del img, hist
    torch.cuda.empty_cache()
    # the shard shapes, which the L-BFGS run below launches too: the
    # Laplacian's a shard's rows and its 2-row halos
    check_path_kernels(dev, f"{label}, Adam and L-BFGS", 1,
                       *spatial_kernel_shapes(size, n, plan), SEED + 32,
                       lap_size=(size // n + 2 * HALO, size))
    lbfgs_label, lbfgs_launches = run_spatial_lbfgs(
        dev, content, style, cm, sm, params, mesh, smi)
    del content, style
    torch.cuda.empty_cache()

    run_spatial_small(dev, gen, mesh)
    run_spatial_lbfgs_small(dev, gen, mesh)
    run_mesh_batch(dev, batch_run)
    return {label: launches, lbfgs_label: lbfgs_launches}, entry


def spatial_gram_rounding(content: np.ndarray, masks: np.ndarray,
                          params: dict, cfg, n: int) -> dict:
    """Where a row-sharded step's Grams part from one device's: the bf16
    taps conv1_1 … conv5_1 of `content` (`cfg`'s style layers) and their
    masked Grams (the masks of `cfg`'s pyramid) by `gram_fwd` on the whole
    image and summed over n row shards, each against the same Grams in
    fp64 (`torch.matmul` of the same bf16 operands): max |error| over
    max |G| (held to SP_GRAM_FP64_TOL) and the mean signed error over
    mean |G|, with each call's split plan (the pixels a split sums)."""
    from dpst_tpu_torch import segmentation
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import gram_stream as gs
    dev = next(iter(params.values()))["w"].device
    layers = cfg.style_layers
    img = torch.from_numpy(content).to(dev)
    pyr = segmentation.layer_masks(torch.from_numpy(masks).to(dev), layers,
                                   cfg.mask_downsample)
    out = {}
    with torch.no_grad():
        taps = vgg.extract_features(params, img, layers,
                                    compute_dtype="bfloat16")
        for layer in layers:
            tap = taps.pop(layer)
            m2 = (pyr[layer] * pyr[layer]).to(torch.bfloat16)
            c, h, w = tap.shape
            f64 = tap.flatten(1).double()
            ref = torch.stack([f64 @ (f64 * mk.flatten().double()).T
                               for mk in m2])
            del f64
            whole = gs.gram_fwd(tap.flatten(1).contiguous(),
                                m2.flatten(1).contiguous()).double()
            step = h // n
            parts = sum(gs.gram_fwd(
                tap[:, i * step:(i + 1) * step].flatten(1).contiguous(),
                m2[:, i * step:(i + 1) * step].flatten(1).contiguous()
            ).double() for i in range(n))
            out[layer] = {
                side: {**fp64_errors(g, ref),
                       "pixels_a_split": gs.fwd_plan(c, p, m2.shape[0])[1]}
                for side, g, p in (("whole", whole, h * w),
                                   ("shards", parts, step * w))}
            del tap, ref, whole, parts
            torch.cuda.empty_cache()
    bad = [f"{layer} {side}: {e['max_rel']} > {SP_GRAM_FP64_TOL[side]}"
           for layer, sides in out.items() for side, e in sides.items()
           if not e["max_rel"] <= SP_GRAM_FP64_TOL[side]]
    emit({"phase": "spatial", "check": f"bf16 Grams against fp64, whole "
          f"and {n} row shards", "size": content.shape[0],
          "tol_max_rel": SP_GRAM_FP64_TOL, "rounding": out})
    if bad:
        fail("spatial", "Grams against fp64: " + "; ".join(bad))
    return out


def spatial_kernel_shapes(size: int, n: int, plan: tuple):
    """The shapes at which a row-sharded step of `size`² over n shards
    (level plan `plan`) launches the Gram pair and the pool backward:
    [(C, P) of each style tap's Grams], [(C, h, W) of each pool's input],
    each a shard's where its level is sharded and the whole level's where
    it is gathered."""
    chans = (64, 128, 256, 512, 512)
    rows = lambda l: (size >> l) // (n if plan[l] else 1)
    grams = [(chans[l], rows(l) * (size >> l)) for l in range(5)]
    pools = [(chans[b - 1], (size >> (b - 1)) // (n if plan[b] else 1),
              size >> (b - 1)) for b in range(1, 5)]
    return grams, pools


def check_path_kernels(dev, label: str, b: int, grams: list, pools: list,
                       seed: int, lap_size: int | tuple | None = None
                       ) -> dict:
    """`gram_fwd`, `gram_bwd` and `pool_bwd` (and, with `lap_size`,
    `lap_matvec` at lap_size² or at (rows, columns) lap_size) at the shapes
    a path launches them with (b
    pairs, K = 4 masks, bf16; the Laplacian fp32), each against its plain
    version pair by pair at the kernels phase's tolerances (forward 1e-3
    of max|G|, against the plain version in fp64, whose fp32 error is
    reported; backward 1e-2 of max|dF|, the pool bit for bit, the
    Laplacian 1e-5 of max|y|). Returns {kernel shape: error}."""
    from dpst_tpu_torch.ops import gram_stream as gs
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.ops import laplacian_cuda as lapc
    from dpst_tpu_torch.ops import pool_cuda
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {}
    with torch.no_grad():
        if lap_size:
            lh, lw = ((lap_size, lap_size) if isinstance(lap_size, int)
                      else lap_size)
            img = torch.rand((b, lh, lw, 3), generator=gen, device=dev)
            packed = torch.stack([lapc.pack_stats(lap.precompute_stats(i))
                                  for i in img])
            v3 = torch.rand((b, 3, lh, lw), generator=gen, device=dev)
            rel = pair_errors(lapc.lap_matvec(packed, v3),
                              lapc.lap_matvec_plain(packed, v3))[1]
            key = f"lap_matvec B={b} {lh}x{lw}"
            errs[key] = rel
            if not rel <= 1e-5:
                fail("spatial", f"{label}: {key} rel err {rel} > 1e-5")
            del img, packed, v3
        for c, p in grams:
            f, _, m2, s = batched_input("gram", b, c, p, K, torch.bfloat16,
                                        dev, gen)
            # the forward's plain version in fp64 (the operand products
            # rounded to bf16 as the plain version rounds them): past 2^18
            # pixels its fp32 sums drift from fp64 faster than the
            # kernel's split sums (1.7e-4 at 2^18, 3.4e-5 at 2^16)
            g64 = torch.stack([torch.matmul(
                f[i].double(), (f[i].unsqueeze(0) * m2[i].unsqueeze(1))
                .double().transpose(1, 2)) for i in range(b)])
            errs[f"gram_fwd plain fp32 vs fp64 B={b} {c}x{p}"] = pair_errors(
                gs.gram_fwd_plain(f, m2), g64)[1]
            for name, got, want, tol in (
                    ("gram_fwd", gs.gram_fwd(f, m2), g64, 1e-3),
                    ("gram_bwd", gs.gram_bwd(f, m2, s),
                     gs.gram_bwd_plain(f, m2, s), 1e-2)):
                rel = pair_errors(got, want)[1]
                key = f"{name} B={b} {c}x{p}"
                errs[key] = rel
                if not rel <= tol:
                    fail("spatial", f"{label}: {key} rel err {rel} > {tol}")
            del g64
            del f, m2, s
            torch.cuda.empty_cache()
        for c, h, w in pools:
            x, y, g = tied_pool_input(b * c, h, w, torch.bfloat16, dev, gen)
            got = pool_cuda.maxpool2_bwd(x, y, g)
            want = pool_cuda.maxpool2_bwd_plain(x, y, g)
            key = f"pool_bwd B={b} {c}x{h}x{w}"
            errs[key] = rel_err(got, want)[0]
            if not torch.equal(got, want):
                fail("spatial", f"{label}: {key} not bit-equal (max err "
                     f"{errs[key]})")
            del x, y, g, got, want
            torch.cuda.empty_cache()
    emit({"phase": "spatial", "check": "kernels at the path's shapes",
          "path": label, "B": b, "K": K, "dtype": "bfloat16",
          "tol_rel": {"gram_fwd": 1e-3, "gram_bwd": 1e-2,
                      "pool_bwd": "bit-exact", "lap_matvec": 1e-5},
          "errors": errs})
    return errs


def run_spatial_small(dev, gen, mesh) -> None:
    """512² bf16 (PRESETS["config3"], laplacian "pallas", RERUN_ITERS
    steps) on the row mesh against the same resolved config unsharded
    (history within SP_HIST_TOL of each column's max, mean |pixel|
    reported) and against a rerun (bit for bit); then a 64² fp32 sharded
    run on the card against the same sharded run on the CPU (1e-3)."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import spatial as sp
    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = textured_image(gen, dev, SIZE).cpu().numpy()
    cm, sm = band_masks(K, SIZE, 0, 0), band_masks(K, SIZE, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              laplacian_impl="pallas",
                              iterations=RERUN_ITERS)
    runs = [sp.stylize_spatial(content, style, cm, sm, cfg, params, mesh)
            for _ in range(2)]
    (img, hist), (img2, hist2) = [(a.cpu().numpy(), b.cpu().numpy())
                                  for a, b in runs]
    ref_img, ref_hist = dpst_tpu_torch.stylize(
        content, style, dataclasses.replace(cfg.spmd_safe(),
                                            laplacian_impl="xla"),
        content_masks=cm, style_masks=sm, vgg_params=params,
        return_history=True)
    rel = np.abs(hist - ref_hist) / np.maximum(
        np.abs(ref_hist).max(axis=0), 1e-30)
    d = np.abs(img - ref_img)
    identical = bool(np.array_equal(hist, hist2)
                     and np.array_equal(img, img2))
    emit({"phase": "spatial", "check": "512² bf16, 4 shards against "
          "unsharded", "iterations": RERUN_ITERS,
          "hist_rel_by_column": rel.max(axis=0).tolist(),
          "row0_rel": float(rel[0].max()), "total_tol_rel": SP_HIST_TOL,
          "row0_tol_rel": BATCH_ROW0_TOL, "hist_tol_rel": BATCH_HIST_TOL,
          "pixel_mean": float(d.mean()), "pixel_max": float(d.max()),
          "rerun_bit_identical": identical})
    if not (rel[:, 0].max() <= SP_HIST_TOL and rel.max() <= BATCH_HIST_TOL
            and rel[0].max() <= BATCH_ROW0_TOL and identical):
        fail("spatial", f"512² sharded: hist rel {rel.max(axis=0)}, row 0 "
             f"{rel[0].max()}, rerun identical {identical}")

    size, k = 64, 3
    content = smooth_image(gen, dev, size).cpu().numpy()
    style = smooth_image(gen, dev, size).cpu().numpy()
    cm, sm = stripe_masks(k, size)
    cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32", iterations=5,
                                       regularization_weight=100.0)
    params = vgg.init_params(SEED)
    hists = {where: sp.stylize_spatial(
        content, style, cm, sm, cfg, params,
        sp.make_spatial_mesh(devices=[where] * SP_SHARDS))[1].cpu().numpy()
        for where in ("cuda", "cpu")}
    worst = float((np.abs(hists["cuda"] - hists["cpu"]) / np.maximum(
        np.abs(hists["cpu"]).max(axis=0), 1e-30)).max())
    emit({"phase": "reference", "path": "config3 spatial, 4 shards",
          "size": size, "K": k, "iterations": 5, "compute_dtype": "float32",
          "max_rel_err_vs_cpu": worst, "tol_rel": SP_REF_TOL})
    if not worst <= SP_REF_TOL:
        fail("reference", f"spatial 64²: card vs CPU history rel err "
             f"{worst} > {SP_REF_TOL}")


def count_syncs(fn):
    """(fn's result, the synchronizing CUDA operations it ran, their count
    by the Python line that ran each): torch's sync debug mode warns at
    each, and the warnings are counted."""
    import collections
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    return out, sum(sites.values()), dict(sites)


def run_spatial_lbfgs(dev, content, style, cm, sm, params, mesh,
                      smi: str) -> None:
    """`stylize_spatial` of PRESETS["config3"] with optimizer="lbfgs",
    laplacian_impl="pallas" (→ "spmd"), bf16, at SP_SIZE² on the row mesh
    `mesh` (SP_SHARDS virtual shards), SP_LBFGS_ITERS steps: counters
    reset just before and read just after, equal to the spatial path's
    launches an evaluation × E (`spatial_launches` of E) and the
    precompute's; peak memory; the loss falls; the first history row
    within SP_ROW0_TOL of a one-step unsharded L-BFGS run of the same
    resolved config. Then the loop alone on the sharded constants: steps/s
    and evaluations/s, the synchronizing operations an evaluation (the
    linesearch fetches each evaluation's value and slope in one copy), and
    device ms an evaluation by group from a profile of one step."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import spatial as sp
    n, size = SP_SHARDS, content.shape[0]
    label = (f"config3 spatial L-BFGS {size}², {n} row shards (virtual "
             f"mesh, one card)")
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs", laplacian_impl="pallas",
                              iterations=SP_LBFGS_ITERS)
    rcfg = cfg.spmd_safe()
    plan = sp.level_plan(size, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with optimize.record_evaluations() as rec:
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, hist = sp.stylize_spatial(content, style, cm, sm, cfg, params,
                                       mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    img, hist = img.cpu().numpy(), hist.cpu().numpy()
    ev = lbfgs_evaluations(rec)
    need = spatial_launches(plan, n, ev["E"])

    # the loop alone: the constants precomputed and sharded once
    pp = vgg.params_by_device(params, list(mesh.devices.flat),
                              rcfg.compute_dtype, rcfg.conv_impl)
    arrays = [torch.from_numpy(a).to(dev)[None]
              for a in (content, style, cm, sm)]
    consts = dpst_tpu_torch.prepare_constants(*arrays, rcfg, pp[mesh.first])
    sc, shards = sp.shard_spatial(consts, arrays[0].clone(), mesh)
    del consts, arrays
    weights = optimize.LossWeights.from_config(rcfg)
    seg = lambda steps: optimize.drain(sp.spatial_segment(
        shards, sc, weights, pp, steps, rcfg))
    torch.cuda.synchronize()
    with optimize.record_evaluations() as rec_t:
        t0 = time.perf_counter()
        seg(SP_LBFGS_ITERS)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    e_t = lbfgs_evaluations(rec_t)["E"]
    with optimize.record_evaluations() as rec_s:
        _, syncs, sync_sites = count_syncs(lambda: seg(1))
    e_s = lbfgs_evaluations(rec_s)["E"]
    with optimize.record_evaluations() as rec_p:
        groups = profile_spatial(lambda: seg(1), 1)
    e_p = lbfgs_evaluations(rec_p)["E"]
    groups = {g: ms / e_p for g, ms in groups.items()}
    busy = sum(groups.values())
    del sc, shards
    torch.cuda.empty_cache()

    # the first row against one unsharded L-BFGS step (the loss at the
    # start), of each column's max over the sharded run
    _, hist1 = dpst_tpu_torch.stylize(
        content, style, dataclasses.replace(rcfg, laplacian_impl="xla",
                                            iterations=1),
        content_masks=cm, style_masks=sm, vgg_params=params,
        return_history=True)
    row0 = np.abs(hist[0] - hist1[0]) / np.maximum(
        np.abs(hist).max(axis=0), 1e-30)
    emit({"phase": "spatial", "path": label, "size": size, "shards": n,
          "K": K, "iterations": SP_LBFGS_ITERS,
          "compute_dtype": cfg.compute_dtype,
          "laplacian_impl": rcfg.laplacian_impl, "level_plan": list(plan),
          "weights": weights_label(), "wall_s": wall_s,
          "evaluations": ev["E"], "evaluations_per_step": ev["per_step"],
          "num_linesearch_steps": ev["linesearch"],
          "safe_steps": ev["safe_steps"],
          "loop_s": loop_s, "loop_evaluations": e_t,
          "steps_per_s": SP_LBFGS_ITERS / loop_s,
          "evaluations_per_s": e_t / loop_s,
          "syncs_one_step": syncs, "evaluations_one_step": e_s,
          "sync_sites": sync_sites,
          "device_ms_per_evaluation": groups,
          "device_busy_ms_per_evaluation": busy,
          "evaluation_ms_unprofiled": loop_s * 1e3 / e_t,
          "max_memory_gb": peak, "launches": launches,
          "launches_expected": need, "first_row": hist[0].tolist(),
          "last_row": hist[-1].tolist(),
          "unsharded_first_row": hist1[0].tolist(),
          "first_row_rel_err": row0.tolist(), "row0_tol_rel": SP_ROW0_TOL,
          "nvidia_smi": smi})
    bad = [f"{k} launched {launches[k]} times, E = {ev['E']} implies {v}"
           for k, v in need.items() if launches[k] != v]
    if ev["fresh"] != ev["fresh_expected"]:
        bad.append(f"{ev['fresh']} fresh evaluations, optax's rule implies "
                   f"{ev['fresh_expected']}")
    if not hist[-1, 0] < hist[0, 0]:
        bad.append(f"total loss did not fall: {hist[0, 0]} -> {hist[-1, 0]}")
    if not (img.shape == (size, size, 3) and np.isfinite(img).all()
            and img.min() >= 0.0 and img.max() <= 255.0):
        bad.append("output not finite (H, W, 3) in [0, 255]")
    if not row0.max() <= SP_ROW0_TOL:
        bad.append(f"first row {row0.tolist()} from the unsharded step")
    # one fetch of value and slope an evaluation, and one copy of the
    # segment's history to the device
    if not e_s <= syncs <= e_s + 1:
        bad.append(f"{syncs} synchronizing operations for {e_s} "
                   f"evaluations")
    if bad:
        fail("spatial", f"{label}: " + "; ".join(bad))
    return label, launches


def lbfgs_trajectory_errors(img, hist, ref_img, ref_hist) -> dict:
    """The L-BFGS golden's measures of a run against a reference: SSIM of
    the images, the relative error of the history's column 0 by row."""
    from dpst_tpu_torch.ops import metrics
    rel = np.abs(hist[:, 0] - ref_hist[:, 0]) / np.abs(ref_hist[:, 0])
    return {"ssim": float(metrics.ssim(torch.from_numpy(img),
                                       torch.from_numpy(ref_img))),
            "rel_err_per_row": rel.tolist()}


def lbfgs_bounds_bad(e: dict, row0_tol: float) -> list:
    """What of `lbfgs_trajectory_errors`'s `e` breaks the L-BFGS golden's
    bounds, the first row held to `row0_tol`."""
    rel = np.asarray(e["rel_err_per_row"])
    bad = []
    if not e["ssim"] >= LBFGS_SSIM_MIN:
        bad.append(f"SSIM {e['ssim']} < {LBFGS_SSIM_MIN}")
    if not rel[0] <= row0_tol:
        bad.append(f"row 0 rel err {rel[0]} > {row0_tol}")
    if not (rel[:10].max() <= LBFGS_HIST10_RTOL
            and rel.max() <= LBFGS_HIST_RTOL):
        bad.append(f"rows rel err {rel.max()} (bounds {LBFGS_HIST10_RTOL} "
                   f"/ {LBFGS_HIST_RTOL})")
    return bad


def run_spatial_lbfgs_small(dev, gen, mesh) -> None:
    """512² bf16 L-BFGS (PRESETS["config3"], laplacian "pallas",
    LBFGS_SHORT steps) on the row mesh against the same resolved config
    unsharded (the L-BFGS golden's bounds, the first row within
    BATCH_ROW0_TOL: the shards' bf16 Grams round apart) and against a
    rerun (bit for bit, evaluation counts included); then 64² fp32
    L-BFGS runs, sharded and unsharded, on the card and on the CPU: on the
    card sharded against unsharded, and card against CPU sharded and
    unsharded, each within the golden's bounds (row 0 within
    LBFGS_ROW0_TOL); evaluation counts within ±2 a step; and one
    evaluation of the sharded objective and its gradient, card against
    CPU, at the content image and at the CPU run's last image within
    LBFGS_EVAL_TOL. (The card's fp32 convs are ATen's own, `vgg.conv2d`:
    on cuDNN this trajectory ended at SSIM 0.80 card against CPU and 0.94
    sharded against unsharded on the card.)"""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import spatial as sp
    content = smooth_image(gen, dev, SIZE).cpu().numpy()
    style = textured_image(gen, dev, SIZE).cpu().numpy()
    cm, sm = band_masks(K, SIZE, 0, 0), band_masks(K, SIZE, 1, 0)
    params = vgg.get_params(seed=SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs", laplacian_impl="pallas",
                              iterations=LBFGS_SHORT)
    runs = []
    for _ in range(2):
        with optimize.record_evaluations() as rec:
            img, hist = sp.stylize_spatial(content, style, cm, sm, cfg,
                                           params, mesh)
        runs.append((img.cpu().numpy(), hist.cpu().numpy(),
                     [r["evaluations"] for r in rec]))
    with optimize.record_evaluations() as rec:
        ref_img, ref_hist = dpst_tpu_torch.stylize(
            content, style, dataclasses.replace(cfg.spmd_safe(),
                                                laplacian_impl="xla"),
            content_masks=cm, style_masks=sm, vgg_params=params,
            return_history=True)
    ref_counts = [r["evaluations"] for r in rec]
    (img, hist, counts), (img2, hist2, counts2) = runs
    e = lbfgs_trajectory_errors(img, hist, ref_img, ref_hist)
    identical = bool(np.array_equal(hist, hist2)
                     and np.array_equal(img, img2) and counts == counts2)
    emit({"phase": "spatial", "check": f"512² bf16 L-BFGS, {SP_SHARDS} "
          "shards against unsharded", "iterations": LBFGS_SHORT, **e,
          "evaluations": counts, "unsharded_evaluations": ref_counts,
          "tol": {"ssim_min": LBFGS_SSIM_MIN, "row0": BATCH_ROW0_TOL,
                  "rows 0-9": LBFGS_HIST10_RTOL, "all": LBFGS_HIST_RTOL},
          "rerun_bit_identical": identical})
    bad = lbfgs_bounds_bad(e, BATCH_ROW0_TOL)
    if not identical:
        bad.append("the rerun is not bit-identical")
    if bad:
        fail("spatial", "512² sharded L-BFGS: " + "; ".join(bad))

    size, k = 64, 3
    content = smooth_image(gen, dev, size).cpu().numpy()
    style = smooth_image(gen, dev, size).cpu().numpy()
    cm, sm = stripe_masks(k, size)
    cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=LBFGS_SHORT, optimizer="lbfgs",
        regularization_weight=100.0)
    params = vgg.init_params(SEED)
    out = {}
    for where, sharded in itertools.product(("cuda", "cpu"), (True, False)):
        with optimize.record_evaluations() as rec:
            if sharded:
                img, hist = sp.stylize_spatial(
                    content, style, cm, sm, cfg, params,
                    sp.make_spatial_mesh(devices=[where] * SP_SHARDS))
                img, hist = img.cpu().numpy(), hist.cpu().numpy()
            else:
                img, hist = dpst_tpu_torch.stylize(
                    content, style, dataclasses.replace(
                        cfg.spmd_safe(), laplacian_impl="xla"),
                    content_masks=cm, style_masks=sm, vgg_params=params,
                    return_history=True, device=where)
        out[where, sharded] = (img, hist, np.asarray(
            [r["evaluations"] for r in rec]))
    pairs = {"card against CPU, sharded": (("cuda", True), ("cpu", True)),
             "card against CPU, unsharded": (("cuda", False),
                                             ("cpu", False)),
             "sharded against unsharded, card": (("cuda", True),
                                                 ("cuda", False)),
             "sharded against unsharded, CPU": (("cpu", True),
                                                ("cpu", False))}
    e = {name: {**lbfgs_trajectory_errors(*out[a][:2], *out[b][:2]),
                "evaluation_steps_apart": int(np.abs(out[a][2]
                                                     - out[b][2]).max())}
         for name, (a, b) in pairs.items()}
    # the objective and its input gradient, card against CPU, at the
    # content image and at the CPU run's last image: one evaluation each
    points = {"content image": content,
              "cpu's last image": out["cpu", True][0]}
    at = {name: {where: sharded_value_grad(
        img, where, cfg, params, content, style, cm, sm)
        for where in ("cuda", "cpu")} for name, img in points.items()}
    evals = {name: {"value_rel": abs(v["cuda"][0] - v["cpu"][0])
                    / abs(v["cpu"][0]),
                    "grad_rel": float((v["cuda"][1] - v["cpu"][1]).abs()
                                      .max() / v["cpu"][1].abs().max())}
             for name, v in at.items()}
    emit({"phase": "reference", "path": f"config3 spatial L-BFGS, "
          f"{SP_SHARDS} shards", "size": size, "K": k,
          "iterations": LBFGS_SHORT, "compute_dtype": "float32", **e,
          "evaluations": {f"{w}, {'sharded' if s_ else 'unsharded'}":
                          o[2].tolist() for (w, s_), o in out.items()},
          "one_evaluation_card_vs_cpu": evals,
          "tol": {"row0": LBFGS_ROW0_TOL, "ssim_min": LBFGS_SSIM_MIN,
                  "rows 0-9": LBFGS_HIST10_RTOL, "all": LBFGS_HIST_RTOL,
                  "evaluations": 2,
                  "one evaluation": LBFGS_EVAL_TOL}})
    # sharding on the card, and the card against the CPU: the golden's
    # bounds
    bad = [f"{name}: {b}" for name in (
        "sharded against unsharded, card", "card against CPU, sharded",
        "card against CPU, unsharded")
        for b in lbfgs_bounds_bad(e[name], LBFGS_ROW0_TOL)]
    bad += [f"{name}: evaluation counts differ by more than 2 at a step"
            for name, v in e.items() if not v["evaluation_steps_apart"] <= 2]
    bad += [f"{name}: {v}" for name, v in evals.items()
            if not max(v.values()) <= LBFGS_EVAL_TOL]
    if bad:
        fail("reference", "spatial L-BFGS 64²: " + "; ".join(bad))


def sharded_value_grad(image, where: str, cfg, params, content, style, cm,
                       sm) -> tuple:
    """The row-sharded objective of `cfg` (SP_SHARDS shards on `where`)
    at `image` (H, W, 3), with the constants of the pair, and its input
    gradient (on the host): (value, gradient)."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import spatial as sp
    mesh = sp.make_spatial_mesh(devices=[where] * SP_SHARDS)
    rcfg = cfg.spmd_safe()
    pp = vgg.params_by_device(params, list(mesh.devices.flat),
                              rcfg.compute_dtype, rcfg.conv_impl)
    arrays = [torch.from_numpy(np.asarray(a)).to(mesh.first)[None]
              for a in (content, style, cm, sm, image)]
    consts = dpst_tpu_torch.prepare_constants(*arrays[:4], rcfg,
                                              pp[mesh.first])
    sc, shards = sp.shard_spatial(consts, arrays[4], mesh, rcfg.style_norm)
    shards = [s.requires_grad_(True) for s in shards]
    total, _ = sp.make_spatial_loss(rcfg)(
        shards, sc, optimize.LossWeights.from_config(rcfg), pp)
    grad = torch.cat(torch.autograd.grad(total, shards), dim=-3)
    return float(total.detach()), grad.cpu()


def run_mesh_batch(dev, b: dict) -> None:
    """`stylize_batch` of the batch phase's BATCH pairs over a virtual mesh
    of SP_MESH_BATCH (the pairs split, BATCH / SP_MESH_BATCH a device, the
    groups' steps in turns; the config `spmd_safe`): each pair against the
    batch phase's one-device run within the batch tolerances, the counters
    SP_MESH_BATCH × one pair's under the resolved config, pair-it/s of the
    call (precompute included), the kernels at its B = BATCH /
    SP_MESH_BATCH shapes against their plain versions
    (`check_path_kernels`). Then a 2 × 2 mesh batch of two 64² pairs
    and `autotune` over a mesh of two at 64², fp32, card against CPU: the
    histories within 1e-3 of each column's max, autotune's images within
    the JAX package's batch bounds (rtol 1e-2, atol 0.25)."""
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import kernels
    from dpst_tpu_torch.parallel import mesh as ml
    m = SP_MESH_BATCH
    label = f"config3 batch B={BATCH} 512² over a virtual mesh of {m}"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    images, hist = dpst_tpu_torch.stylize_batch(
        b["contents"], b["styles"], b["cm"], b["sm"], b["cfg"],
        vgg_params=b["params"], mesh=ml.make_mesh(devices=[dev] * m))
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = b["cfg"].iterations
    need = dict.fromkeys(kernels.KERNELS, 0)
    need.update(lap_matvec=m * steps, gram_fwd=m * (5 * steps + 5),
                gram_bwd=m * 5 * steps, pool_bwd=m * 4 * steps,
                bias_relu_fwd=m * (13 * steps + 23),
                bias_relu_bwd=m * 13 * steps)
    errs = []
    for i in range(BATCH):
        rel = np.abs(hist[i] - b["hist"][i]) / np.maximum(
            np.abs(b["hist"][i]).max(axis=0), 1e-30)
        d = np.abs(images[i] - b["images"][i])
        errs.append({"row0_rel": float(rel[0].max()),
                     "hist_rel": float(rel.max()),
                     "pixel_mean": float(d.mean()),
                     "pixel_max": float(d.max())})
    emit({"phase": "spatial", "path": label, "wall_s": wall_s,
          "pair_it_s_virtual": BATCH * steps / wall_s,
          "launches": launches, "launches_expected": need,
          "vs_one_device_batch": errs, "row0_tol_rel": BATCH_ROW0_TOL,
          "hist_tol_rel": BATCH_HIST_TOL, "pixel_tol": BATCH_PIXEL_TOL})
    bad = [f"{k} launched {launches[k]} times, expected {v}"
           for k, v in need.items() if launches[k] != v]
    bad += [f"pair {i}: {e}" for i, e in enumerate(errs)
            if not (e["row0_rel"] <= BATCH_ROW0_TOL
                    and e["hist_rel"] <= BATCH_HIST_TOL
                    and e["pixel_mean"] <= BATCH_PIXEL_TOL)]
    if bad:
        fail("spatial", f"{label}: " + "; ".join(bad))
    check_path_kernels(dev, label, BATCH // m,
                       *spatial_kernel_shapes(SIZE, 1, (True,) * 5),
                       SEED + 33, lap_size=SIZE)

    size = 64
    gen = torch.Generator().manual_seed(SEED + 31)
    contents = torch.stack([smooth_image(gen, gen.device, size)
                            for _ in range(2)]).cpu().numpy()
    styles = torch.stack([smooth_image(gen, gen.device, size)
                          for _ in range(2)]).cpu().numpy()
    cm, sm = batch_masks(2, size, 3)
    cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32", iterations=5,
                                       regularization_weight=100.0)
    params = vgg.init_params(SEED)
    hists = {where: dpst_tpu_torch.stylize_batch(
        contents, styles, cm, sm, cfg, vgg_params=params,
        mesh=ml.make_mesh_2d(2, 2, devices=[where] * 4))[1]
        for where in ("cuda", "cpu")}
    worst = float((np.abs(hists["cuda"] - hists["cpu"]) / np.maximum(
        np.abs(hists["cpu"]).max(axis=1, keepdims=True), 1e-30)).max())
    tune_cfg = dataclasses.replace(cfg, use_segmentation=False)
    tunes = {where: dpst_tpu_torch.autotune(
        contents[0], styles[0], tune_cfg, gammas=(1.0, 100.0),
        vgg_params=params, mesh=ml.make_mesh(devices=[where] * 2))
        for where in ("cuda", "cpu")}
    pix = np.abs(tunes["cuda"].images - tunes["cpu"].images)
    pix_ok = bool(np.all(pix <= 0.25 + 1e-2 * np.abs(tunes["cpu"].images)))
    emit({"phase": "reference", "path": "batch on a 2 × 2 mesh, autotune "
          "on a mesh of 2", "size": size, "compute_dtype": "float32",
          "batch_max_rel_err_vs_cpu": worst, "tol_rel": SP_REF_TOL,
          "autotune_pixel_max_vs_cpu": float(pix.max()),
          "autotune_within_batch_bounds": pix_ok,
          "autotune_scores": {k: v.scores.tolist() for k, v in tunes.items()}})
    if not (worst <= SP_REF_TOL and pix_ok):
        fail("reference", f"mesh runs card vs CPU: batch {worst}, autotune "
             f"pixels {pix.max()}")


def cli_run(name: str, args: list, refused: bool = False,
            expect: tuple = ()) -> float:
    """`python3 -m dpst_tpu_torch <args>` in a process of its own from the
    repository's root, on the card; fails the cli phase where it exits
    non-zero (or, `refused`, with 0) or a piece of `expect` is missing from
    its output. Returns its wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dpst_tpu_torch", *args],
                         cwd=root, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    missing = [e for e in expect if e not in res.stdout + res.stderr]
    if (res.returncode != 0) != refused or missing:
        fail("cli", f"{name}: rc {res.returncode}, missing {missing}; "
             f"stdout {res.stdout[-1500:]!r}; stderr {res.stderr[-1500:]!r}")
    return wall


def run_cli(dev, gen, smi: str) -> None:
    """The phase "cli": `python3 -m dpst_tpu_torch` in subprocesses on the
    card at 512², through the entry points the flags pick: masked config3
    (K = 4 band masks as .npy, a loss CSV, intermediates at 50 and 100)
    held bit for bit to an in-process `stylize` of the same files, masks
    and config (CSV against the history, PNG against the rounded image);
    config3 without masks (PSPNet, automatic masks); a directory of
    CLI_DIR_IMAGES images without segmentation (`stylize_batch`);
    `--autotune` over four Γ, one round; L-BFGS with the post-process and
    --metrics; --spatial over the CUDA devices, with Adam and with L-BFGS;
    and two failures, --device
    99 and --laplacian-impl spmd without --spatial. Each run's wall
    seconds on one line with the card's name and power limit."""
    import tempfile

    import dpst_tpu_torch
    from dpst_tpu_torch.utils import io

    torch.cuda.empty_cache()  # the subprocesses take memory of their own
    with tempfile.TemporaryDirectory(prefix="dpst_cli_") as d:
        j = lambda *parts: os.path.join(d, *parts)
        io.save_image(smooth_image(gen, dev, SIZE).cpu().numpy(),
                      j("content.png"))
        io.save_image(textured_image(gen, dev, SIZE).cpu().numpy(),
                      j("style.png"))
        np.save(j("cm.npy"), band_masks(K, SIZE, 0, 0))
        np.save(j("sm.npy"), band_masks(K, SIZE, 1, 0))
        os.makedirs(j("dir"))
        for i in range(CLI_DIR_IMAGES):
            io.save_image(smooth_image(gen, dev, SIZE).cpu().numpy(),
                          j("dir", f"{i}.png"))
        pair = ["--content", j("content.png"), "--style", j("style.png"),
                "--preset", "config3", "--size", str(SIZE)]
        masks = ["--content-masks", j("cm.npy"), "--style-masks", j("sm.npy")]
        steps = ["--iterations", str(CLI_ITERS)]
        walls = {}
        walls["masked config3"] = cli_run("masked config3", pair + masks
                                          + steps + [
            "--output", j("out.png"), "--loss-csv", j("loss.csv"),
            "--intermediate-interval", str(CLI_ITERS // 2),
            "--intermediate-dir", j("inter")],
            expect=("final losses", "wrote " + j("loss.csv")))
        inter = sorted(os.listdir(j("inter")))
        csv = np.loadtxt(j("loss.csv"), delimiter=",", skiprows=1)
        cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                                  iterations=CLI_ITERS,
                                  intermediate_interval=CLI_ITERS // 2)
        img, hist = dpst_tpu_torch.stylize(
            j("content.png"), j("style.png"), cfg, size=SIZE,
            content_masks=np.load(j("cm.npy")),
            style_masks=np.load(j("sm.npy")),
            callback=lambda *_: None, return_history=True)
        png = io.load_image(j("out.png"))
        same_csv = bool(csv.shape == hist.shape
                        and np.array_equal(csv, hist.astype(np.float64)))
        same_png = bool(np.array_equal(png, io.to_uint8(img)))
        want = [f"iter_{CLI_ITERS // 2:05d}.png", f"iter_{CLI_ITERS:05d}.png"]
        emit({"phase": "cli", "run": "masked config3", "csv_shape":
              list(csv.shape), "intermediates": inter,
              "csv_equals_in_process_history": same_csv,
              "png_equals_in_process_image": same_png,
              "max_abs_history_diff": float(np.abs(
                  csv - hist.astype(np.float64)).max()) if csv.shape ==
              hist.shape else None})
        if not (csv.shape == (CLI_ITERS, 5) and inter == want and same_csv
                and same_png):
            fail("cli", f"masked config3: CSV {csv.shape} equal {same_csv}, "
                 f"PNG equal {same_png}, intermediates {inter}")
        walls["automatic masks"] = cli_run(
            "automatic masks", pair + steps + ["--output", j("auto.png")],
            expect=("final losses",))
        walls["directory"] = cli_run("directory", [
            "--content-dir", j("dir"), "--style", j("style.png"),
            "--preset", "config3", "--size", str(SIZE), "--no-segmentation",
            *steps, "--output", j("dir_out")],
            expect=(f"stylized {CLI_DIR_IMAGES} images",))
        outs = sorted(os.listdir(j("dir_out")))
        if outs != [f"{i}.png" for i in range(CLI_DIR_IMAGES)]:
            fail("cli", f"directory: outputs {outs}")
        walls["autotune"] = cli_run("autotune", pair + masks + [
            "--autotune", "--gamma-candidates", *CLI_GAMMAS,
            "--tune-rounds", "1", "--iterations", str(CLI_TUNE_ITERS),
            "--output", j("tuned.png")], expect=("autotune: best Γ =",))
        walls["lbfgs"] = cli_run("lbfgs", pair + masks + steps + [
            "--optimizer", "lbfgs", "--post-smooth", "2", "--metrics",
            "--output", j("lbfgs.png")],
            expect=("SSIM=", "PSNR=", "final loss: total="))
        n = torch.cuda.device_count()
        walls["spatial"] = cli_run("spatial", pair + masks + steps + [
            "--spatial", str(n), "--output", j("sp.png")],
            expect=(f"{n}-way row-sharded", "final losses"))
        walls["spatial lbfgs"] = cli_run("spatial lbfgs", pair + masks
                                         + steps + [
            "--spatial", str(n), "--optimizer", "lbfgs",
            "--output", j("sp_lbfgs.png")],
            expect=(f"{n}-way row-sharded", "final losses"))
        walls["--device 99"] = cli_run(
            "--device 99", pair + ["--device", "99"], refused=True,
            expect=("--device 99 out of range",))
        walls["spmd without --spatial"] = cli_run(
            "spmd without --spatial", pair + ["--laplacian-impl", "spmd"],
            refused=True, expect=("needs a row-sharded mesh",))
        for name in ("out.png", "auto.png", "tuned.png", "lbfgs.png",
                     "sp.png", "sp_lbfgs.png"):
            out = io.load_image(j(name))
            if out.shape != (SIZE, SIZE, 3):
                fail("cli", f"{name}: shape {out.shape}")
    emit({"phase": "cli", "size": SIZE, "iterations": CLI_ITERS,
          "wall_s": walls, "nvidia_smi": smi})


def summarize(rows: list, launches: dict, k: int = K, b: int = 1) -> list:
    """One entry per kernel: times and bounds summed over the shapes one
    step of its main path launches (512² config3 for the first four
    kernels, the 1024² stage of config4 for the fused Gram pair, the 512²
    pallas route for conv3x3 and gram_wbwd, the 4096² config6 step for the
    block12 entry points), in the main path's dtype (bf16; fp32 for the
    Laplacian); max_abs_err over those shapes (for block12, over its bf16
    checks).
    `launches` sums the counts of all main-path runs, `launches_by_path`
    gives each. With k = K8 the entries are the Gram kernels' rows at
    K8 classes (gram_fwd and gram_bwd at the 512² taps, the fused pair at
    conv1_1 of 512²), named "<kernel> K=8", with the launches of the
    automatic and autotune paths. With b = BATCH the entries are the
    batched rows ("<kernel> B=8": the five kernels with a batch grid
    dimension and the pool backward on folded channels, at the batch
    path's shapes, B pairs' bounds) with the batch path's launches and
    `looped_ms`, the same work as b one-pair launches."""
    meta = {
        "lap_matvec": ("dpst_tpu_torch/csrc/lap_matvec.cu",
                       "dpst_tpu/ops/laplacian_pallas.py:111", None,
                       "float32"),
        "gram_fwd": ("dpst_tpu_torch/csrc/gram.cu",
                     "dpst_tpu/ops/gram_stream.py:93",
                     "dpst_tpu/ops/gram_pallas.py:41", "bfloat16"),
        "gram_bwd": ("dpst_tpu_torch/csrc/gram.cu",
                     "dpst_tpu/ops/gram_stream.py:110", None, "bfloat16"),
        "gram_relu_fwd": ("dpst_tpu_torch/csrc/gram.cu",
                          "dpst_tpu/ops/gram_s2d.py:231",
                          "dpst_tpu/ops/gram_s2d.py:138", "bfloat16"),
        "gram_relu_bwd": ("dpst_tpu_torch/csrc/gram_relu_bwd.cu",
                          "dpst_tpu/ops/gram_s2d.py:260",
                          "dpst_tpu/ops/gram_s2d.py:175", "bfloat16"),
        "gram_wbwd": ("dpst_tpu_torch/csrc/gram.cu",
                      "dpst_tpu/ops/gram_pallas.py:66",
                      "dpst_tpu/ops/gram_stream.py:110", "bfloat16"),
        "pool_bwd": ("dpst_tpu_torch/csrc/pool_bwd.cu",
                     "dpst_tpu/ops/pool_pallas.py:40", None, "bfloat16"),
        "conv3x3": ("dpst_tpu_torch/csrc/conv3x3.cu",
                    "dpst_tpu/ops/conv_pallas.py:62", None, "bfloat16"),
        "block12_fwd": ("dpst_tpu_torch/csrc/block12.cu",
                        "dpst_tpu/ops/block12_pallas.py:216", None,
                        "bfloat16"),
        "block12_fwd_res": ("dpst_tpu_torch/csrc/block12.cu",
                            "dpst_tpu/ops/block12_pallas.py:570", None,
                            "bfloat16"),
        "block12_bwd_deep": ("dpst_tpu_torch/csrc/block12.cu",
                             "dpst_tpu/ops/block12_pallas.py:355", None,
                             "bfloat16"),
        "block12_bwd_shallow": ("dpst_tpu_torch/csrc/block12.cu",
                                "dpst_tpu/ops/block12_pallas.py:379", None,
                                "bfloat16"),
    }
    if k != K:
        meta = {name: meta[name] for name in ("gram_fwd", "gram_bwd",
                                              "gram_relu_fwd",
                                              "gram_relu_bwd")}
    if b == BATCH:
        meta = {name: meta[name] for name in (
            "lap_matvec", "gram_fwd", "gram_bwd", "gram_relu_fwd",
            "gram_relu_bwd", "pool_bwd", "gram_wbwd", "conv3x3")}
        meta["gram_wbwd"] = ("dpst_tpu_torch/csrc/gram_wbwd_pairs.cu",
                             *meta["gram_wbwd"][1:])
    elif b != 1:
        meta = {name: meta[name] for name in meta if name.startswith(
            "block12")}
    out = []
    for name, (src, replaces, also, dtype) in meta.items():
        sel = [r for r in rows if r["name"] == name and r["dtype"] == dtype
               and r.get("in_step", True) and r.get("K", K) in (k, None)
               and r.get("B", 1) == b
               and (b != B12_BATCH or r["shape"] == [B12_SIZE, B12_SIZE])]
        t_bytes = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
        t_ops = sum(r["bound_ms"] for r in sel
                    if r["bound_by"] == "operations")
        libs = [r["library_ms"] for r in sel]
        by_path = {path: counts[name] for path, counts in launches.items()}
        entry = {
            "name": (name if k == K else f"{name} K={k}")
            + ("" if b == 1 else f" B={b}"), "route": "cuda",
            "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if any(v is None for v in libs)
                           else sum(libs)),
            "dtype": dtype, "K": k, "shapes_per_step": len(sel)}
        if b != 1:
            entry["B"] = b
            entry["looped_ms"] = sum(r["looped_ms"] for r in sel)
        if also:
            entry["also_replaces"] = also
        if "library_call" in sel[0]:
            entry["library_call"] = sel[0]["library_call"]
        out.append(entry)
    return out


def wgmma_resources(lib) -> dict:
    """Registers, local memory (spills and stack), dynamic shared memory and
    resident blocks per SM of the bf16 Gram bodies (csrc/gram_wgmma.cuh:
    gram_fwd, gram_relu_fwd on its body, gram_bwd, block12's Gram cotangent
    on gram_bwd's body, gram_wbwd) and
    conv bodies (csrc/conv3x3_wgmma.cuh: conv3x3's N tiles of 128, 64 and
    8 channels, and block12's instances)."""
    import ctypes
    out = {}
    entries = [(lib.dpst_gram_wgmma_attrs, which, name) for which, name in
               enumerate(("gram_fwd", "gram_bwd (64-row c tile)",
                          "gram_bwd (128-row c tile)",
                          "gram_relu_fwd (bias+ReLU prologue)",
                          "gram_wbwd (64-row c tile, C = 64)",
                          "gram_wbwd (128-row c tile, C = 512)",
                          "gram_relu_bwd (C <= 64 body, K = 4)",
                          "gram_relu_bwd (gram_wbwd's body, 128-row c "
                          "tile, C = 512)"))]
    entries += [(functools.partial(lib.dpst_conv3x3_attrs, bn, cps), None,
                 f"conv3x3 (N tile {bn}, {what})")
                for bn, cps, what in (
                    (128, 4, "4 chunks a block"),
                    (64, 1, "1 chunk a block, two blocks an SM"),
                    (64, 2, "2 chunks a block"),
                    (8, 1, "1 chunk a block"))]
    entries += [(lib.dpst_block12_df_attrs, which, name)
                for which, name in enumerate((
                    "block12 Gram cotangent of conv1_1 (64-row c tile)",
                    "block12 Gram cotangent of conv2_1 (128-row c tile)"))]
    entries += [(lib.dpst_block12_conv_attrs, which, name)
                for which, name in enumerate((
                    "block12 conv1_1 (K = 32, bias+ReLU)",
                    "block12 conv1_2 (bias+ReLU, N tile 64, 1 chunk)",
                    "block12 conv2_2 (bias+ReLU, N tile 128, 2 chunks)",
                    "block12 input gradient of conv2_1 (N tile 64, 2 chunks)",
                    "block12 input gradient of conv1_1 (N tile 8, 1 chunk)"))]
    for fn, which, name in entries:
        vals = (ctypes.c_int * 4)()
        rc = fn(vals) if which is None else fn(which, vals)
        if rc != 0:
            fail("build", f"{name}: error {rc}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes",
                              "blocks_per_sm"), vals))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dpst_tpu_torch  # fails outside the repository
    from dpst_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    lib = kernels.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    emit({"phase": "build", "wgmma_kernels": wgmma_resources(lib)})
    # ptxas's C7514: it serialized a kernel's wgmma (a register an
    # in-flight wgmma writes was touched by another instruction)
    emit({"phase": "build", "wgmma_serialized": [
        line.strip() for text in kernels.BUILD_LOG.values()
        for line in text.splitlines() if "C7514" in line]})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rows = check_lap(dev, gen)
    check_lap_oracle(dev)
    rows += check_gram(dev, gen)
    check_gram_split_cap(dev, torch.Generator(device=dev).manual_seed(
        SEED + 40))
    rows += check_gram_relu(dev, gen)
    rows += check_pool(dev, gen)
    rows += check_gram_wbwd(dev, gen)
    rows += check_conv(dev, gen)
    check_edges(dev, gen)
    check_bias_relu(dev, torch.Generator(device=dev).manual_seed(SEED + 50))
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += check_block12(dev, gen)
    rows += check_gram_dz(dev, gen)
    rows += check_block12_batch(dev, torch.Generator(device=dev).manual_seed(
        SEED + 25))
    seconds["block12 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += check_batched(dev, torch.Generator(device=dev).manual_seed(
        SEED + 20))
    rows += check_batched_wbwd_conv(dev, torch.Generator(
        device=dev).manual_seed(SEED + 24))
    seconds["batched kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # generators of their own: the main paths' images do not depend on
    # what the kernel checks drew
    main_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    launches = {"config3 512²": run_main_path(dev, main_gen)}
    run_small_reference(main_gen, dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=5, regularization_weight=100.0),
        "config3")
    ms_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    launches["config4 256²→1024²"] = run_multiscale(dev, ms_gen)
    ref = run_small_reference(ms_gen, dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", scales=(16, 32, 64), scale_iters=(2, 2, 2),
        s2d_gram="pallas", block1_impl="s2d", regularization_weight=100.0),
        "config4-shaped, fused route")
    if not ref["gram_relu_fwd"] == ref["gram_relu_bwd"] == 6:
        fail("reference", f"fused route not taken at every step: {ref}")
    pl_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    launches["config3 pallas route 512²"] = run_pallas_route(dev, pl_gen)
    ref = run_small_reference(pl_gen, dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=5, regularization_weight=100.0,
        conv_impl="pallas", gram_impl="pallas"), "config3 pallas route")
    # 64² is below the fused block-1 route: all five taps take gram_wbwd
    if not (ref["conv3x3"] == 24 * 5 + 21 and ref["gram_wbwd"] == 25):
        fail("reference", f"pallas route not taken at every step: {ref}")
    s12_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    launches["config6 4096² stream12 route"], s12_one = run_stream12(
        dev, s12_gen)
    s12_cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=2, regularization_weight=100.0,
        stream12=8, stream12_impl="pallas")
    ref = run_small_reference(s12_gen, s12_cfg, "stream12 route", size=256)
    ref_b = run_small_batch_reference(s12_gen, s12_cfg, "stream12 route",
                                      size=256)
    for counts in (ref, ref_b):
        if not (counts["block12_fwd_res"] == counts["block12_bwd_deep"]
                == counts["block12_bwd_shallow"] == 2
                and counts["block12_fwd"] == 0):
            fail("reference", f"stream12 route not taken at every step "
                 f"(once for the batch): {counts}")
    launches_b12 = {f"config6 batch B={B12_BATCH} 4096²": run_stream12_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 26), smi,
        s12_one)}

    seconds["main paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lb_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    launches["config3 L-BFGS 512²"] = run_lbfgs(dev, lb_gen, smi)
    seconds["lbfgs"] = time.perf_counter() - t0
    launches_k8 = run_automatic_stages(dev)
    seconds["segmentation, automatic, autotune"] = (time.perf_counter()
                                                    - t0 - seconds["lbfgs"])
    t0 = time.perf_counter()
    launches_b, batch_run = run_batch_path(
        dev, torch.Generator(device=dev).manual_seed(SEED + 21), smi)
    launches_b = {
        f"config3 batch B={BATCH} 512²": launches_b,
        f"config3 pallas route batch B={BATCH} 512²": run_batch_pallas(
            dev, batch_run, smi),
        f"config3 L-BFGS batch B={BATCH} 512²": run_batch_lbfgs(
            dev, batch_run, smi)}
    seconds["batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches_sp, spmd_entry = run_spatial(
        dev, torch.Generator(device=dev).manual_seed(SEED + 22), smi,
        batch_run)
    spmd_entry["launches_by_path"] = {
        path: n["lap_matvec"] for path, n in launches_sp.items()}
    spmd_entry["launches"] = sum(spmd_entry["launches_by_path"].values())
    launches.update(launches_sp)
    seconds["spatial"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(dev, torch.Generator(device=dev).manual_seed(SEED + 23), smi)
    seconds["cli"] = time.perf_counter() - t0
    emit({"phase": "timing", "seconds": seconds})
    print(smi, flush=True)
    emit({"kernels": summarize(rows, launches)
          + summarize(rows, launches_k8, K8)
          + summarize(rows, launches_b, b=BATCH)
          + summarize(rows, launches_b12, b=B12_BATCH) + [spmd_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
