#!/usr/bin/env python3
"""Smoke run of the PyTorch port (csl_gan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --gn-plans   # steps 1-2, then K4/K5 over every plan
    python3 chip_smoke.py --saves      # steps 1-2, then step 5 alone
    python3 chip_smoke.py --dp-modes   # step 1, K4/K5's build, then step 7 alone
    python3 chip_smoke.py --cond-archs # step 1, K2-K5's build, then step 8 alone
    python3 chip_smoke.py --public-data # steps 1-2, then step 9 alone
    python3 chip_smoke.py --dp-surface  # steps 1-2, then step 10 alone
    python3 chip_smoke.py --interop     # steps 1-2, then step 11 alone
    python3 chip_smoke.py --surface     # steps 1-2, then step 12 alone
    python3 chip_smoke.py --parallel    # steps 1-2, then step 13 alone
    python3 chip_smoke.py --tp          # steps 1-2, then step 14 alone
    python3 chip_smoke.py --clip        # step 1, K6's build, then step 6's K6 checks

From the root of a checkout, on a machine with one NVIDIA H100 and the CUDA
toolkit, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel of the ported paths from the sources (one nvcc per
     translation unit, all in parallel: K1 is six, its tile GEMM's five
     product forms beside the rest) and prints the build time, each unit's
     seconds and the ptxas report; checks in the SASS (dumped in the
     background, read after step 4) that K2/K3 hold warpgroup MMA
     instructions and that K1 holds no tensor-core instruction (its products
     are fp32 FFMA);
  3. MNIST path (K1). Holds K1 against its plain PyTorch version on the
     card, at the path's full width (bs 600, F 784, nc 10, latent 100,
     H 128), with seeded inputs: 5 steps with DP from the initial state, 5
     without DP from a mid-training Adam state, and 5 with DP on an fp32
     table; it also prints, without holding it to the bound, the gap of 5
     steps without DP from zero Adam moments. Runs K1 twice on the same
     inputs and fails unless state and metrics are bitwise equal, and
     prints the split plan of a step (each product's tile, BK, splits and
     CTAs). Then drives the path through
     its entry point, the port's Trainer on ``MNIST --conditional -dpm gc
     --sigma 10 -bs 600 -tss 60000`` (synthetic MNIST) for 2 epochs in one
     group, checks the K1 launch count, finite losses and epsilon, prints
     ms/epoch and samples/s, and times K1 and its plain version on one
     100-step epoch with the device time by CUDA kernel and by product
     group and the CUDA launches per step (torch.profiler);
  4. CelebA path (K2-K5). Holds K2/K3 against their plain versions at the
     flagship's ghost-order layers conv2-conv4 and K4/K5 at the generator's
     five norm shapes (B 128, bf16; fp32 at B 8 and at the flagship's first
     norm; both dtypes at ragged geometries, one of them two-pass), each
     K4/K5 pair run twice (bitwise equal), its launch plan and residency
     printed, K5's ReLU mask checked against the one K4 applied, its bf16
     outputs counted in ulps (none may be more than one ulp off,
     ReLU-boundary cases left out) and its CUDA launches a call counted in a
     profiler trace against the plan's, timing each beside its plain
     version and one PyTorch library call where one computes the same
     function (for K5, the autograd backward of group_norm + relu). K2
     and K3 have two variants: the tensor-core one, which these bf16 layers
     take, is also held at a bf16 geometry with ragged edges, the FFMA one
     at the same layers with fp32 operands (B 8), and the two are timed in
     turns (FFMA, tensor cores, tensor cores, FFMA) per layer with TFLOP/s
     and the share of the bf16 bound, by CUDA events around the wrapper
     calls and by device time (torch.profiler);
     holds one port D step and one G step at full width (bs 8; fp32, and
     bf16 compute) through K2-K5 against the same steps through the plain
     versions, both on the card, and prints two witnesses beside the gap
     (the plain steps repeated, and the plain steps with z moved by 1e-7
     relative; in bf16, K2-K5 are held against the all-plain step to 3x its
     own witness with K4/K5's outputs moved by one ulp on the share of
     elements K4/K5 moved); drives
     the path through its entry point, the port's Trainer on ``CelebA
     --conditional -dpm gc -bs 128 -tss 12800 -nms 1 --mean_sample_size 8
     --bf16 true --train_d_until_threshold 1e18`` (synthetic CelebA, full
     celeba_g64 / celeba_d64 width) for 1 epoch, checks that K2-K5 each
     launched (K2 and K3 three times per D step, each time the tensor-core
     variant), finite losses and epsilon, prints ms per D step and samples/s,
     and the device time by CUDA kernel of the first 5 D steps of one more
     epoch (``PROFILE_STEPS``; the K4/K5 group must be non-zero, there and
     on path 2);
  5. saves and resume (outputs under build/chip_smoke/saves/). The MNIST
     flagship through K1 (bs 600, -tss 60000) and the CelebA flagship
     through K2-K5 (deterministic cuDNN): 2 epochs with a save every epoch
     (CelebA twice, the witness) against 1 epoch and 1 more resumed from its
     saves/*-1 with ``-rp <dir> -re 1 -ne 2 -ka n_epochs``; fails unless
     saves G-2 / D-2 (params, Adam moments and counts, clipping, accountant,
     generator states) are bitwise equal (CelebA: held to 3x the gap of its
     two uninterrupted runs, were they not equal), the privacy_log.csv rows
     are equal, each CSV has one header, and the path's kernels launched
     after the resume. Checks the sample grids (MNIST each epoch, CelebA
     every 50 D steps) and mean-sample PNGs by pixel size; holds
     sample_images at the CelebA grid (B 24) and gensamples' batch (B 50)
     through K4: each K4 call against its plain version (the groupnorm
     phase's bound), the images against the plain G forward to 3x a witness
     (K4's outputs moved one ulp on the share each call moved), K4's CUDA
     launches counted where gn_relu.cu issues them (a profiler trace of the
     same call may read no more). Sends SIGTERM to the port's CLI
     (a subprocess on the MNIST flagship) after its first privacy_log.csv
     row: it must exit 0, print "Preempted after epoch" and leave its
     saves; 1 more epoch resumed from them must continue epsilon. Runs
     gensamples (CelebA, -n 60 -bs 50), temp_file (both models),
     budget_analysis and mem_inf_attack (MNIST, pixel FID) on the saves,
     each timed. downstream is not run here: scikit-learn is not installed
     on the card's machine; the CPU tests cover it. Prints each save's and
     load's ms and MB and the resumed runs' time to their first epoch,
     each beside the card's name and power limit;
  6. materialized per-sample-gradient paths (K6). Right after the build,
     while a profiler trace of a short window still reads in full, holds K6
     against its plain version (the same Philox stream) at path 1's leaf
     [600, 101632],
     at every large leaf of celeba_d64 at B 128, at an odd P, at the leaf
     gate's P = 16384, at [128, 8192] and at batch 50: the sum at std 0, sum
     and noise at std 2.5 with one seed, another seed, the same seed twice
     (bitwise), and the noise's moments; then one launch over path 2's four
     leaves and over the four ``-pupd false`` slices at ``--tp 2`` at their
     counter bases (each to the same bounds, bitwise on a rerun, each leaf's
     noise its whole leaf's); times each by CUDA events and on the device
     beside its plain version, ``w @ g`` + ``std * torch.randn`` (both
     clocks) and its bytes bound. In its place
     after step 5, holds the MNIST ghost-clipped real sum against the
     materialized one (bs 600), and one full-width D
     step of each path through K6 against the same step through K6's plain
     version with the same seeds. Then drives, through the Trainer, path 1
     (``MNIST --conditional -dpm gc --sigma 10 -bs 600 --pallas true
     --grad_clip_split false``) and path 2 (``CelebA --conditional -dpm gc
     -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true
     --train_d_until_threshold 1e18 --conv_ghost false --pallas true``) for 1
     epoch each, counts K6's launches (one a D step) and leaves, and prints ms per D step beside the
     K1 path's and the conv-ghost path's of the same run, where each step's
     time goes (vmap(grad), norms, K6 and small leaves, the rest) and the
     device time by CUDA kernel of 5 more D steps;
  7. the D-step engines beside gc (outputs under build/chip_smoke/dp_modes/).
     Through the Trainer, one epoch each, timed by CUDA events, then 5 more
     steps under the profiler: MNIST (``MNIST --conditional --sigma 10
     -bs 600 -tss 60000``) with ``-dpm is``, ``-dpm is -ispp true``, ``-dpm is
     -issm moving-avg-pl`` (at ``--sigma 0.01``: at 10 its scaling vector
     overflows, in the JAX package too), ``-dpm tm`` and ``-dpm sv``; CelebA (the
     flagship's flags with ``-tss 1280`` and the mode swapped) with ``-dpm
     is`` (per parameter, CelebA's default), ``-dpm tm`` and no ``-dpm``.
     Prints ms per D step, the device-busy share, peak memory, the logged IS
     Mean / Min / Max and epsilon; fails on a non-finite metric or
     parameter. The DCResNet G has GroupNorm (K4/K5) when per-sample
     gradients are on (tm) and BatchNorm otherwise (is, no DP), as in the
     JAX package: K4/K5 must launch on the tm path (wrapper counts and CUDA
     launches in a trace) and on no other. Holds one bf16 tm D step and G
     step through K4/K5 against the same steps with the plain versions, to
     3x a one-ulp witness, and prints where a per-parameter is D step's time
     goes (first-order pass, the batched second-order pass, the rest);
  8. the conditional variants (outputs under build/chip_smoke/cond_archs/).
     Through the Trainer, 1 epoch each, every kernel's launches counted by
     its wrapper, then 5 steps under the profiler:
     CelebA (the flagship's flags with ``-tss 1280``) as CGAN, WCGAN,
     unconditional and ACGAN with ``--g_label_emb_mode embed``, where K2 and
     K3 must launch 3 times a D step, all on the tensor cores, K4 9 times a
     G forward (one a D step's fakes, one a G update), K5 9 times a G update,
     K1 and K6 never, and conv1 (3 + n_classes input planes under CGAN and
     WCGAN) must take the direct order; MNIST (``-dpm gc --sigma 10 -bs
     600``, 100 steps an epoch) as unconditional, CGAN and WCGAN, which leave
     K1 for the step runner: no kernel may launch. Each run checks finite
     logs and parameters, the update counts and epsilon (the port's
     accountant recomputed for the steps, plus the mean samples' cost) and
     prints ms per D step (beside the ACGAN flagship's and the K1 path's of
     the same run), the device-busy share and peak memory. Then one bf16
     WCGAN and one CGAN D + G step (bs 8) through K2-K5 against the all-plain
     step, held to 3x the one-ulp witness as the ACGAN step is;
  9. public data, warmup and adaptive clipping (outputs under
     build/chip_smoke/public/). Through the Trainer, 1 epoch each after its
     warmup, every kernel's launches counted by its wrapper: the MNIST
     flagship with ``-nms 2 --mean_sample_size 10 -wi 2`` (the 2 warmup
     steps on the step runner, then K1 once an epoch from the reset Adam
     counts; the D save's Adam count 100 an epoch); CelebA (the flagship's
     flags cut to ``-tss 1280``) with ``-pss 1280 -gcm adaptive -wi 2`` and
     with ``-gcm adaptive-pl -nms 1 --mean_sample_size 8 -wi 2`` (K2 6 times
     and K3 3 times a DP step, all on the tensor cores, K4 9 times a G
     forward, K5 9 times a G update, K1 and K6 never; the saved thresholds
     finite, positive and not the initial ones); path 1 with ``-tss 6000
     -gcm adaptive -nms 1 --mean_sample_size 10`` (K6 once a D step); and a
     batch of 50: CelebA ``-bs 50 -tss 500`` (K2-K5 on the tensor cores) and
     MNIST ``-dpm gc --conditional -bs 50 -tss 5000`` (no kernel: K1 takes
     batches that are multiples of 8). Each run checks finite logs and
     parameters, the update counts and epsilon (no warmup step counted) and
     prints ms per D step beside the flagship's of the same run, the
     device-busy share of one more epoch, peak memory and the card. Then one
     bf16 adaptive CelebA D + G step (bs 8) through K2-K5 against the
     all-plain step (3x the one-ulp witness), one adaptive path-1 D step
     through K6 against K6's plain version (same seeds, same adapted std),
     and K2/K3 at conv2-conv4, K4/K5 at the G's five norm shapes and K6 at
     [50, 101632], all at batch 50, against their plain versions to the
     bounds of steps 4 and 6, timed beside them;
 10. the rest of the DP training surface (outputs under
     build/chip_smoke/dp_surface/). Through the Trainer, 1 epoch each, every
     kernel's launches counted by its wrapper and held to the count the
     code gives: CelebA (the flagship's flags cut to ``-tss 1280``) with
     ``--poisson true`` (219-row buffers for batch 128: K2/K3 3 times a D
     step on the tensor cores, K4 on each D step's fakes and G update, K5
     on each G update), with ``-pupd false --pallas true`` and no mean
     samples (the per-sample penalty on the materialized route: K6 4 times
     a D step, no K2/K3) and with ``--penalty DRAGAN`` on mean samples; the
     MNIST flagship with ``--poisson true`` (796-row buffers, the step
     runner, no kernel); MNIST cut to ``-tss 6000`` with ``--penalty
     DRAGAN1 -pupd false --pallas true`` and with ``--backprop_clip true
     --pallas true`` (K6 once a D step), and with ``-dpm is --backprop_clip
     true`` (no kernel); K1 never. Each run checks finite logs and
     parameters, the update counts and epsilon, and prints ms per D step
     beside the flagship's of the same run, the device-busy share of 5
     profiled steps and peak memory. Then K2/K3 at conv2-conv4 and K4/K5 at
     the G's five norm shapes at 219 rows (bf16) against their plain
     versions to the bounds of step 4, with the last 91 rows' cotangents
     zero (their K2 norms must be exactly 0, and the K2/K3 results equal
     those of the 128 valid rows alone), each timed; one full-width CelebA
     ``-pupd false`` D step through K6 against K6's plain version (same
     seeds); and, at sigma 0, the per-sample-penalty clipped sum's norm
     within B * C (1 + 1e-5) at C 0.05 (MNIST DRAGAN bs 600, CelebA
     WGAN-GP bs 128, through K6 at std 0) and no sample clipped under
     backprop clipping at the derived bounds (MNIST rows, and rows x 100);
 11. interop with the reference (outputs under build/chip_smoke/interop/).
     Writes a run directory as the reference writes it: the opt.txt of
     ``CelebA --conditional -dpm gc -bs 128 -tss 1280 -nms 1
     --mean_sample_size 8`` at fp32 without the JAX package's extension
     flags, saves/G-1 and D-1 as torch pickles with the upstream key names,
     seeded weights and Adam's state after one step (full celeba_g64 /
     celeba_d64 widths); converts it with the port's
     ``convert_reference_checkpoint`` (timed); holds ``sample_images`` of the
     converted pixel-shuffle G at B 50 through K4 as step 5 does (each K4
     call against its plain version, the images to 3x a one-ulp witness, 9
     K4 calls and 9 CUDA launches); runs the port's
     ``mem_inf_attack --compute_fid --num_generated_samples 2048`` on the
     card with ``$FID_INCEPTION_WEIGHTS`` at an npz of
     ``inception.random_params(0)`` (random weights: not a comparable FID)
     and prints the seconds of sampling, of the Inception features and in
     all, images/s and TFLOP/s through Inception at 299x299; holds the
     features of 100 images on the card against the CPU (relative l2 within
     INCEPTION_BOUND), on ``random_params(0)`` and on fan-in-scaled weights;
     resumes the converted run for 1 epoch (``-rp``, 10 D steps, 2 G
     updates) and requires K2/K3 30 (none of them tensor-core), K4 108 and
     K5 18 launches, the update counts, finite logs and parameters and
     epsilon; holds K2/K3 (FFMA) and K4/K5 against their plain versions at
     every fp32 B 128 shape the resume gave them;
 12. the rest of the single-device surface (outputs under
     build/chip_smoke/surface/). Through the Trainer, one epoch each, every
     kernel's launches counted by its wrapper (K4's also by batch) and held
     to the count the code gives, finite logs and parameters, the update
     counts and epsilon: the MNIST flagship (``-tss 60000``, K1 once) and the
     CelebA flagship's flags cut to ``-tss 1280`` (10 D steps, 2 G updates;
     K2/K3 30 on the tensor cores, K4 108, K5 18), as the phase's
     references (under ``--surface`` alone each after a warm-up run);
     MNIST with ``-wd 1e-4``, ``--u8_table true`` (the gathered batch on the
     card within one ulp of its stored pixels / 255) and ``--bf16 true``, all
     three off K1 (the step runner); MNIST with ``--log_every 12000
     --sample_every 12000`` (K1 once for each of the epoch's 5 segments; the
     log rows' epoch progress and the grids the JAX Trainer's cadence gives);
     CelebA with ``--group_fakes true`` (K4 9 times a G forward, at B 128 for
     the head step and the G updates, 640 for the cadence group, 512 for the
     tail), its end state held to 3x the gap of the per-batch epoch (same
     seed) with each D step's fakes moved as the 640-row forward moves them
     (two per-batch runs are bitwise equal), then K4/K5 at B 640 at the
     G's five norm shapes against their plain versions (step 4's bounds,
     twice bitwise equal), K4 timed; 1280 real-format JPEGs (178x218, with a
     list_attr_celeba.txt) decoded into the cache by the native decoder
     (which must run), memory-mapped on the second call and decoded by PIL
     alone, each timed, then the CelebA flagship's flags trained from the
     cache and with ``--host_loop true`` on the same files (K2-K5 as the
     reference); and CelebA with ``-p`` (the trace under ``profile/``, the
     key-averages table and the sections' summary printed). Prints each
     run's ms per D step beside its flagship's;
 13. multi-device training (outputs under build/chip_smoke/parallel/). The
     card's machine shows one card, so two ``--multihost`` processes share
     it over gloo (NCCL refuses two ranks on one device; ``LOCAL_WORLD_SIZE``
     2 tells each that it shares) and each rank trains its half of every
     batch; each rank is this script again (``--parallel-rank``), counting
     every kernel's launches from 0 around ``csl_gan_tpu_torch.train.main``
     and recording the shapes it gave K2-K6; every run is 1 epoch (no check
     of the phase resumes a run), its ms per D step that epoch's. (a) The
     CelebA flagship's flags cut to ``-tss 1280`` (10 D steps, 2 G updates
     an epoch): on each rank the
     one-rank run's launches (K2/K3 3 times a D step at B 64 on the tensor
     cores, K4 9 times a G forward and K5 9 times a G update, also where
     gn_relu.cu issues them, K1 and K6 never); one full-width D step and G
     step (B 128) from the one-rank run's end state on 2 ranks, replicated
     and under ``--fsdp``, and the runs (rank 0's saves), held
     group by group (D's and G's params and Adam moments) to the one-rank
     state within 3x a witness: the same one-rank step or run computing
     every pass in the ranks' halves (``in_halves``; two one-rank runs are
     bitwise equal); each rank's state bytes and
     ``torch.cuda.memory_allocated`` printed (under ``--fsdp`` a rank must
     hold under 0.6 of the state). (b) Path 1 cut to ``-tss 6000`` (K6 once
     a D step at [300, 101632] a rank, the noise from rank 0) and the MNIST
     flagship's flags cut so (the ghost route; K1 never: the epochs runner
     is the one-device path), each held to its one-rank run on the step
     runner within PAR_FP32_BOUND. The shapes the ranks gave K2-K6 must be
     the one-rank run's with the batch halved, and each is held against its
     plain version (K2/K3 at conv2-conv4 B 64, K4/K5 at the nine norms B 64,
     K6 at [300, 101632]). (c) The MNIST flagship as one ``--multihost``
     process on NCCL (K1 once an epoch), whose saves must equal the plain
     run's byte for byte. Prints ms per D step by rank beside the one-rank
     run's, with the card's name and power limit;
 14. the tensor axis (outputs under build/chip_smoke/tp/; ``--tp`` ranks
     sharing the card over gloo as in step 13): (a) a CelebA D + G step at
     ``--tp 2`` on 2 ranks held to one rank's within 3x the one-rank step
     computed in channel halves (``in_channel_halves``); (b) the MNIST
     ghost-route step on 4 ranks as dp 2 x tp 2 within PAR_FP32_BOUND; (c)
     the CelebA flagship's flags and path 1 for an epoch at ``--tp 2``
     with launches, ms per D step and state MB by rank; (d) one full-width D
     + G step of each engine beside gc's routes (``TP_ENGINE_STEPS``: CelebA
     tm, Poisson, adaptive, ``-pupd false`` on K6, DRAGAN in bf16, each
     within 3x its channel-halves witness; MNIST is, is ``-ispp``, sv and
     bpc on K6 in fp32, within PAR_FP32_BOUND), each rank's launches the
     one-rank step's and its D step timed beside one rank's, and CelebA
     Poisson and path 1 adaptive for an epoch at ``--tp 2``
     (``TP_ENGINE_RUNS``); every shape the ranks gave K2-K6 held against
     its plain version (K4/K5 at 16 groups, K6 at its counter base);
 15. prints one JSON ``kernels`` line (K1-K6: launches on their main path,
     max abs gap to the plain version, ms, plain ms, bound, library ms; K4/K5
     also their launches on the CelebA tm path; every kernel its launches on
     each path of step 8, ``cond_arch_launches``, of step 9,
     ``public_data_launches``, of step 10, ``dp_surface_launches``, of step
     11, ``interop_launches``, and of step 12, ``surface_launches``; K2-K6
     their times at batch 50, ``b50_ms`` / ``b50_plain_ms``, K2-K5 at the
     219-row Poisson buffer, ``b219_ms`` / ``b219_plain_ms``, and K4 at the
     grouped batch, ``b640_ms`` / ``b640_plain_ms``; every kernel its
     launches by rank on each run of step 13, ``parallel_launches``, and of
     step 14, ``tp_launches`` and, for (d), ``tp_engine_launches``);
 16. ends with ``{"ok": true, "device": {...}}`` as the last line.
Before the kernels line it prints ``{"phase_seconds": {...}}``: the seconds
of the run and of each phase, the card's peak allocation by phase, and the
items of each phase (each unit's nvcc, each Trainer's set-up and run, each
rank job, each check). From step 6 on, a full run gives steps 5, 11, 13 and
14 to a second smoke process on the card (``--beside``), beside 6-10 and 12
in this one, and folds its output and seconds into this run's; every ms per
D step after step 4 is then taken on a shared card and host. Step 13's and
14's rank jobs run on sets of rank processes at once (``RankSets``).
Any failure raises or exits non-zero, and no result line is printed. It
needs no network and imports nothing of JAX or of the JAX package. It
leaves no process behind, however it ends: every process it starts
carries ``CHIP_SMOKE_RUN`` in its environment, orphans of its children
are re-parented to it (it is their subreaper), and at its end it stops and
reaps any of them still there and names them on standard error; SIGTERM,
SIGINT and SIGHUP, and its own deadline (``DEADLINE_S``, 1,150 s, inside
the 1,200 s a run is given) end it as a failure does, naming the phase it
was in and that phase's seconds; each child asks the kernel to SIGKILL it
if the smoke dies, so a SIGKILL of the smoke takes its children too.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks by the name nvidia-smi gives (NVIDIA data sheets, dense):
# fp32 outside the tensor cores, bf16 on the tensor cores, and device memory
# bandwidth, at the full power limit. The first match wins.
PEAKS = (("H100 PCIe", 51.2e12, 756e12, 2.0e12), ("H100 NVL", 60.0e12, 835e12, 3.9e12),
         ("H200", 67.0e12, 989e12, 4.8e12), ("H100", 67.0e12, 989e12, 3.35e12))

BS, F, NC, LATENT, H = 600, 784, 10, 100, 128
EPOCHS, CHECK_STEPS, TIME_STEPS = 2, 5, 100
MNIST_FLAGSHIP = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
                  "-tss", "60000"]
# Kernel vs plain: both run the same fp32 arithmetic in another reduction
# order (tiled FFMA sums against PyTorch's kernels with TF32 off), so single
# results agree to ~1e-7 relative and, after 5 Adam steps, params and
# moments to a few 1e-6 with DP and ~1e-5 without (H100). 1e-4 leaves room
# for that drift and still fails on any wrong term, which moves a step's
# update by ~lr / |param| ~ 1e-2 relative.
REL_BOUND = 1e-4


RUN_TAG = "CHIP_SMOKE_RUN"
PR_SET_CHILD_SUBREAPER = 36


def own_run() -> None:
    """Mark this run: every process started from here on inherits the tag
    in its environment, and its orphans come back to this process."""
    import ctypes
    import os
    os.environ[RUN_TAG] = f"{os.getpid()}-{time.time_ns()}"
    if ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def run_processes() -> dict:
    """{pid: (state, command line)} of the processes of this run other
    than this one: its descendants and any process carrying its tag."""
    import os
    me, procs = os.getpid(), {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                state, ppid = fh.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        procs[int(d)] = (state, int(ppid))
    ours, grew = {me}, True
    while grew:
        grew = False
        for pid, (_, ppid) in procs.items():
            if ppid in ours and pid not in ours:
                ours.add(pid)
                grew = True
    tag = f"{RUN_TAG}={os.environ.get(RUN_TAG)}".encode()
    for pid in procs:
        if pid not in ours:
            try:
                with open(f"/proc/{pid}/environ", "rb") as fh:
                    if tag in fh.read().split(b"\0"):
                        ours.add(pid)
            except OSError:
                pass
    out = {}
    for pid in ours - {me}:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            cmd = ""
        out[pid] = (procs[pid][0], cmd[:300])
    return out


def stop_run_processes(grace_s: float = 5.0) -> None:
    """Stop every process of this run still there (SIGTERM, then SIGKILL
    after ``grace_s``), reap them as they end (a process killed a moment ago
    can still be exiting, so until none is left, zombies included), and say
    on standard error what was found."""
    import os
    import signal

    def reap():
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    return
            except ChildProcessError:
                return

    reap()
    found = run_processes()
    for pid, (state, cmd) in sorted(found.items()):
        print(f"chip_smoke: process {pid} of this run still there at its end (state "
              f"{state}): {cmd}", file=sys.stderr)
    deadline = time.time() + grace_s
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid, (state, _) in found.items():
            if state != "Z":
                with contextlib.suppress(OSError):
                    os.kill(pid, sig)
        while found and time.time() < deadline:
            time.sleep(0.1)
            reap()
            found = run_processes()
        deadline = time.time() + grace_s
    reap()
    left = run_processes()
    if left:
        print(f"chip_smoke: processes of this run left: {sorted(left.items())}",
              file=sys.stderr)
    else:
        print("chip_smoke: no process of this run is left", file=sys.stderr)


def dying_with_us(cmd) -> list:
    """The argv that runs cmd so that the kernel kills it (SIGKILL) when this
    process dies, even by SIGKILL (``_build.dying_with_parent``)."""
    from csl_gan_tpu_torch.ops._build import dying_with_parent
    return dying_with_parent(cmd)


# The smoke's own deadline, inside the 1,200 s that a run is given: past it
# the smoke fails, naming the phase it is in, and stops its processes.
DEADLINE_S = 1150.0
STOP_SIGNALS = ("SIGTERM", "SIGINT", "SIGHUP")


def guarded(main_fn, deadline_s: float = DEADLINE_S) -> int:
    """main_fn() as the smoke runs it: its run tagged (``own_run``), SIGTERM,
    SIGINT and SIGHUP turned into a failure (SystemExit, code 128 + the
    signal), a failure past ``deadline_s``, and at its end, however it ends
    short of SIGKILL, the phase_seconds line and every process of the run
    stopped (``stop_run_processes``). A SIGKILL takes its children with it:
    each is started through ``dying_with_us``."""
    import signal

    def stop(msg, code):
        for name in STOP_SIGNALS + ("SIGALRM",):      # one stop: the cleanup runs whole
            signal.signal(getattr(signal, name), signal.SIG_IGN)
        where = CLOCK.where() if CLOCK is not None else "its run"
        print(f"chip_smoke: FAIL: {msg} in {where}", file=sys.stderr, flush=True)
        raise SystemExit(code)

    def on_signal(signum, frame):
        stop(f"stopped by {signal.Signals(signum).name}", 128 + signum)

    def on_deadline(signum, frame):
        stop(f"past the smoke's deadline of {deadline_s:g} s", 1)

    own_run()
    for name in STOP_SIGNALS:
        signal.signal(getattr(signal, name), on_signal)
    signal.signal(signal.SIGALRM, on_deadline)
    signal.setitimer(signal.ITIMER_REAL, deadline_s)
    try:
        return main_fn()
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        for name in STOP_SIGNALS:
            signal.signal(getattr(signal, name), signal.SIG_IGN)
        print_phase_seconds()
        stop_run_processes()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# The phases of a full run by their keys in the phase_seconds line, in the
# order main() runs them, each with the step of the docstring it is.
PHASES = (("card", "1"), ("build", "2"), ("k6_checks", "6 (K6 against plain)"),
          ("mnist", "3"), ("celeba", "4"), ("saves", "5"), ("k6_paths", "6"),
          ("engines", "7"), ("variants", "8"), ("public_data", "9"), ("dp_surface", "10"),
          ("interop", "11"), ("surface", "12"), ("parallel", "13"), ("tp", "14"),
          ("beside", "5, 11, 13, 14: the wait for the second process"),
          ("gn_plans", "--gn-plans"))


class Clock:
    """Seconds of this run by phase and by item (a source's nvcc, a
    Trainer's set-up and run, a rank job, a check), for the phase_seconds
    line: each item under the phase it ran in."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.phases: dict = {}
        self.items: dict = {}
        self.peak_gib: dict = {}            # the card's peak allocation by phase
        self.second = None                  # the phases run in a second process
        self.driven: set = set()            # (kind, config_key) of every run driven
        self.printed = False                # the phase_seconds line printed
        self.current = None                 # (phase, its start)

    @staticmethod
    def _cuda():
        torch = sys.modules.get("torch")
        return torch.cuda if torch is not None and torch.cuda.is_initialized() else None

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in dict(PHASES):
            raise ValueError(f"no phase {name!r} in PHASES")
        if self._cuda():
            self._cuda().reset_peak_memory_stats()
        outer, self.current = self.current, (name, time.perf_counter())
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() \
                - self.current[1]
            if self._cuda():
                self.peak_gib[name] = round(self._cuda().max_memory_allocated() / 2 ** 30, 2)
            self.current = outer

    @contextlib.contextmanager
    def item(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(label, time.perf_counter() - t0)

    def add(self, label: str, seconds: float) -> None:
        key = f"{self.current[0]}: {label}" if self.current else label
        n, base = 2, key
        while key in self.items:
            key, n = f"{base} #{n}", n + 1
        self.items[key] = round(seconds, 3)

    def where(self) -> str:
        """The phase this run is in and its seconds so far."""
        if self.current is None:
            return "before its first phase"
        name, t0 = self.current
        return f"phase {name}, {time.perf_counter() - t0:.1f} s into it"

    def line(self) -> dict:
        return {"phase_seconds": {
            "total": round(time.perf_counter() - self.t0, 3),
            "phases": {k: round(v, 3) for k, v in self.phases.items()},
            "peak_gib": self.peak_gib, "second_process": self.second, "items": self.items}}


# This run's clock (set by main; None where the module is imported).
CLOCK = None

# What a configuration is, apart from the run: the options that name a run
# (its output, seed, length, rank and port) leave it; a path given counts as
# given; a log or sample cadence of whole epochs counts as per epoch.
RUN_ONLY = ("output_dir", "manual_seed", "n_epochs", "resume_epochs", "coordinator_address",
            "process_id")
GIVEN = ("resume_path", "data_path", "label_path")


def config_key(argv) -> tuple:
    """A configuration of the port's CLI as a sorted tuple of (option,
    value), from its argv (``options.build_parser``, no side effect)."""
    from csl_gan_tpu_torch import options as toptions
    ns = vars(toptions.build_parser().parse_args([str(a) for a in argv]))
    defaults = toptions.MNIST_DEFAULTS if ns["dataset"] == "MNIST" else toptions.CELEBA_DEFAULTS
    tss = ns.get("train_set_size") or defaults["train_set_size"]
    out = {}
    for k, v in ns.items():
        if k in RUN_ONLY:
            continue
        if k in GIVEN:
            v = v is not None
        elif k in ("log_every", "sample_every"):
            v = defaults[k] if v is None else v
            v = "whole epochs" if v >= tss else v
        out[k] = v
    return tuple(sorted((k, repr(v)) for k, v in out.items()))


def timed(fn):
    """fn, its calls' seconds an item of the run's clock: the function's name
    and its ``name``, ``tag`` or ``label`` argument, where it has one."""
    import functools
    import inspect
    sig = inspect.signature(fn)
    key = next((k for k in ("name", "tag", "label") if k in sig.parameters), None)

    @functools.wraps(fn)
    def run(*args, **kw):
        if CLOCK is None:
            return fn(*args, **kw)
        tag = sig.bind(*args, **kw).arguments.get(key) if key else None
        with CLOCK.item(fn.__name__ + (f" {tag}" if tag is not None else "")):
            return fn(*args, **kw)
    return run


def clocked(label: str):
    """An item of the run's clock over a block (nothing without a clock)."""
    return CLOCK.item(label) if CLOCK is not None else contextlib.nullcontext()


@contextlib.contextmanager
def mnist_made_once():
    """The port's MNIST arrays (``data.mnist.load_mnist``: without files on
    disk, its deterministic synthetic set, 1.3-2 s to make) made once a
    process over the block; each caller takes its own copy."""
    import functools
    from csl_gan_tpu_torch.data import mnist
    load = functools.lru_cache(maxsize=None)(mnist.load_mnist)

    def copied(data_path, train=True, download=False):
        images, labels = load(data_path, train, download)
        return images.copy(), labels.copy()
    with _swapped(((mnist, "load_mnist", copied),)):
        yield


@contextlib.contextmanager
def trainers_timed(out_root):
    """Every Trainer built and run in this process over the block, its
    set-up (Trainer(...): data, models, mean samples) and its run
    (Trainer.run) items of the run's clock, named by its output directory,
    and its configuration (the argv ``options.parse`` took) recorded in
    ``CLOCK.driven``."""
    import os
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.training.loop import Trainer
    init, run, parse = Trainer.__init__, Trainer.run, toptions.parse
    argvs = {}                               # id(opt) -> the argv parsed into it

    def name(opt):
        return os.path.relpath(opt.output_dir, out_root)

    def recorded_parse(argv=None):
        opt = parse(argv)
        argvs[id(opt)] = (opt, list(argv) if argv is not None else sys.argv[1:])
        return opt

    def timed_init(self, opt, *a, **kw):
        if id(opt) in argvs and argvs[id(opt)][0] is opt:
            CLOCK.driven.add(("Trainer", config_key(argvs.pop(id(opt))[1])))
        with CLOCK.item(f"Trainer {name(opt)}: set-up"):
            init(self, opt, *a, **kw)

    def timed_run(self, *a, **kw):
        with CLOCK.item(f"Trainer {name(self.opt)}: run"):
            return run(self, *a, **kw)
    with _swapped(((Trainer, "__init__", timed_init), (Trainer, "run", timed_run),
                   (toptions, "parse", recorded_parse))):
        yield


def rel_l2(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a - b).norm() / (b.norm() + 1e-30))


def k1_flops(n: int, bs: int = BS, f: int = F, nc: int = NC, lat: int = LATENT,
             h: int = H) -> float:
    """Multiply-adds x2 of one K1 epoch of n steps (the products of
    csrc/k1_epoch.cu, element-wise work left out)."""
    a0, heads = f + nc, 2 * bs * h * (1 + nc)
    g_fwd = 2 * bs * h * (lat + nc) + 2 * bs * f * h
    real = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    fake = 2 * bs * h * a0 + 2 * heads + 2 * bs * h * a0 + heads
    g_step = (g_fwd + 2 * bs * h * a0 + 2 * heads
              + 3 * 2 * bs * f * h + 2 * bs * h * (lat + nc))
    return float(n * (g_fwd + real + fake + g_step))


def k1_bytes(n: int, p_d: int, p_g: int, use_dp: bool) -> float:
    """Bytes K1 must move for an epoch: each input read once (bf16 rows, z,
    one-hot labels, noise, params and moments), each output written once."""
    rows = n * BS * (F + NC + 1) * 2
    rand = 2 * n * BS * LATENT * 4 + n * BS * NC * 4
    noise = n * p_d * 4 if use_dp else 0
    state = 2 * 3 * (p_d + p_g) * 4
    return float(rows + rand + noise + state + 40 * 4)


# ---------------- the MNIST path (K1) ----------------

# K1's CUDA kernels by product group (the profile of one epoch); a GEMM's
# group follows from its template arguments (tile, TA, TB, A and B types).
K1_GROUPS = (("split-K reduce passes", "splitk_reduce"), ("bias sums", "colsum_kernel"),
             ("row, Adam, metrics", "row_kernel"), ("row, Adam, metrics", "adam_kernel"),
             ("row, Adam, metrics", "metrics_kernel"))


def k1_group(name: str) -> str:
    for group, key in K1_GROUPS:
        if key in name:
            return group
    if "gemm_kernel<" not in name:
        return "other"
    # gemm_kernel<BM, BN, BK, TA, TB, TTA, TTB>
    args = [a.strip() for a in name.split("gemm_kernel<", 1)[1].split(">", 1)[0].split(",")]
    form = {("true", "false"): "TN weighted sums", ("false", "true"): "NT forwards",
            ("false", "false"): "NN G backward"}[(args[3], args[4])]
    bf16 = " (bf16 table rows)" if any("bfloat16" in a for a in args[5:]) else ""
    return f"{form}{bf16}"


def mnist_builder(dev, out_root, use_dp: bool, tag: str):
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    argv = ["MNIST", "--conditional", "--sigma", "10", "-bs", str(BS),
            "-tss", "60000", "--manual_seed", "1", "--platform", "gpu",
            "-o", str(out_root / tag)] + (["-dpm", "gc"] if use_dp else [])
    opt = toptions.parse(argv)
    G, D = init_models(opt, dev)
    b = StepBuilder(opt, G, D)
    b.labels_in_table = b.onehot_in_table = True
    return b


def mnist_inputs(dev, b, n: int, use_dp: bool, seed: int, warm: bool = False):
    """K1's inputs for n steps, drawn on the card from a seed."""
    import torch
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.models.common import one_hot
    from csl_gan_tpu_torch.models.mnist import D_LEAVES
    from csl_gan_tpu_torch.ops import grads as gops
    from csl_gan_tpu_torch.ops import pallas_epoch as pe

    imgs, labels = synthetic_mnist(n * BS, seed=seed)
    x = torch.from_numpy(imgs.reshape(n * BS, -1)).to(dev)
    y = torch.from_numpy(labels).to(dev)
    rows = torch.cat([x, one_hot(y, NC), y[:, None].float()], 1).to(torch.bfloat16)
    g = torch.Generator(dev).manual_seed(seed)
    z_d, z_g = b.gen_z(g, BS, (n,)), b.gen_z(g, BS, (n,))
    ohg = one_hot(b.gen_y(g, BS, (n,)), NC)
    st = b.init_state()
    noise = (gops.noise_like(g, [st.d_params[k] for k in D_LEAVES],
                             gops.noise_std(b.sigma, st.clipping), lead=(n,))
             if use_dp else None)
    params, mu, nu = pe.leaves_of(st)
    t = (0, 0)
    if warm:
        # Mid-training Adam state: seeded moments of the size the first
        # epochs leave (|grad| ~ 1e-3) and counts past an epoch.
        mu = [1e-3 * torch.randn(x.shape, generator=g, device=dev) for x in mu]
        nu = [(3e-3 * torch.randn(x.shape, generator=g, device=dev)) ** 2 + 1e-8
              for x in nu]
        t = (300, 300)
    return (rows, z_d, z_g, ohg, noise, st.clipping, t, params, mu, nu)


@timed
def k1_check_phase(dev, out_root) -> float:
    """K1 against its plain version at full width in four cases, the same
    inputs through K1 twice (bitwise equal), and the split plan. Returns the
    largest absolute gap of the held cases."""
    import torch
    from csl_gan_tpu_torch.models.mnist import D_LEAVES, G_LEAVES
    from csl_gan_tpu_torch.ops import pallas_epoch as pe

    # With DP from the initial state (the main path's start), without DP
    # from a mid-training Adam state. At count 0 without noise, Adam's first
    # update is ~sign(grad), so the few grad elements within fp32 rounding
    # of zero flip sign between any two summation orders and the state
    # drifts by 2 lr there; with nonzero moments the update is smooth in the
    # gradient, so the check holds to the bound.
    max_abs = 0.0
    # (use_dp, table dtype, mid-training Adam state, held to the bound). The
    # third case stores the table in fp32 (--bf16_table false); the last is
    # only printed, to show the size of the sign sensitivity above.
    cases = ((True, torch.bfloat16, False, True), (False, torch.bfloat16, True, True),
             (True, torch.float32, False, True), (False, torch.bfloat16, False, False))
    for use_dp, row_dtype, warm, held in cases:
        b = mnist_builder(dev, out_root, use_dp, f"check_dp{int(use_dp)}")
        ins = mnist_inputs(dev, b, CHECK_STEPS, use_dp, seed=11, warm=warm)
        ins = (ins[0].to(row_dtype),) + ins[1:]
        outk = pe.epoch_kernel(b, *ins, use_dp=use_dp)
        outp = pe.epoch_plain(b, *ins, use_dp=use_dp)
        torch.cuda.synchronize()
        worst, abs_err, per_leaf = 0.0, 0.0, []
        names = [f"D.{k}" for k in D_LEAVES] + [f"G.{k}" for k in G_LEAVES]
        for group, gk, gp in zip(("param", "mu", "nu"), outk[:3], outp[:3]):
            for name, xk, xp in zip(names, gk, gp):
                r = rel_l2(xk, xp)
                per_leaf.append((r, f"{group} {name}"))
                worst = max(worst, r)
                abs_err = max(abs_err, float((xk - xp).abs().max()))
        per_leaf.sort(reverse=True)
        mk, mp = outk[3], outp[3]
        cont = [s for s in range(pe.MET_SLOTS) if s not in
                (pe.M_D_RACC, pe.M_D_FACC, pe.M_D_RAUX_ACC, pe.M_G_AUX_ACC)
                and not pe.M_FRAC <= s < pe.M_FRAC + 6]
        met_rel = rel_l2(mk[cont], mp[cont])
        # Accuracy and clipped-share slots count samples; one sample on the
        # other side of a threshold moves a step's value by 100/bs (or 1/bs).
        count_gap = float(max((mk - mp)[[pe.M_D_RACC, pe.M_D_FACC,
                                          pe.M_D_RAUX_ACC, pe.M_G_AUX_ACC]].abs().max(),
                              100.0 * (mk - mp)[pe.M_FRAC:pe.M_FRAC + 6].abs().max()))
        print(f"kernel vs plain (dp={use_dp}, rows {row_dtype}, "
              f"{'mid-training' if warm else 'zero'} moments, {CHECK_STEPS} steps): "
              f"max rel l2 state {worst:.3e}, metrics {met_rel:.3e}, count slots "
              f"{count_gap:.3e}, max abs {abs_err:.3e} "
              + (f"(bound {REL_BOUND:g})" if held else "(printed only)"))
        print("  worst leaves: " + ", ".join(f"{n} {r:.2e}" for r, n in per_leaf[:3]))
        if held and not (worst < REL_BOUND and met_rel < REL_BOUND
                         and count_gap <= 2 * 100.0 * CHECK_STEPS / BS):
            fail(f"K1 disagrees with its plain version (dp={use_dp})")
        if not all(torch.isfinite(x).all() for g in outk[:3] for x in g):
            fail("K1 produced non-finite state")
        if held:
            max_abs = max(max_abs, abs_err, float((mk - mp)[cont].abs().max()))

    # Split-K adds its partials in a fixed order and nothing is atomic, so
    # the same inputs give the same bits.
    b = mnist_builder(dev, out_root, True, "repeat")
    ins = mnist_inputs(dev, b, CHECK_STEPS, True, seed=13)
    one, two = pe.epoch_kernel(b, *ins), pe.epoch_kernel(b, *ins)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for g1, g2 in zip(one[:3], two[:3]) for u, v in zip(g1, g2))
    print(f"K1 twice on the same inputs ({CHECK_STEPS} DP steps): state "
          f"{'bitwise equal' if same else 'DIFFERS'}, metrics "
          f"{'bitwise equal' if torch.equal(one[3], two[3]) else 'DIFFER'}")
    if not (same and torch.equal(one[3], two[3])):
        fail("K1 is not bitwise repeatable")

    plan = pe.split_plan(b, ins[0], ins[1], ins[7])
    print(f"K1 split plan of one step on {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs (M x N x K: tile, BK, splits, CTAs): "
          + "; ".join(f"{m}x{n}x{k}: {bm}x{bn}, BK {bk}, S {sp}, {c}"
                      for m, n, k, bm, bn, bk, sp, c in plan))
    return max_abs


def mnist_path_phase(out_root):
    """The MNIST path through its entry point. Returns (K1 launches, ms per
    epoch after the first)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.training.loop import Trainer

    e = EPOCHS
    opt = toptions.parse(MNIST_FLAGSHIP + ["-ne", str(e), "--log_every", str(60000 * e),
                                           "--manual_seed", "1", "-o", str(out_root / "train")])
    tr = Trainer(opt)
    pe.epoch_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pe.epoch_kernel.launches
    if launches != e:
        fail(f"K1 launched {launches} times on the main path, expected {e}")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    eps, losses = mnist_run_checked(tr, e)
    samples = tr.n_batches * BS
    rest = ep_ms[1:] or ep_ms
    k1_epoch_ms = sum(rest) / len(rest)
    print(f"MNIST path: {e} epochs x {tr.n_batches} steps in one group, K1 launches "
          f"{launches}; epoch ms first {ep_ms[0]:.3f}, rest mean "
          f"{sum(rest) / len(rest):.3f} ({', '.join(f'{x:.3f}' for x in rest)}); "
          f"{samples * len(rest) / (sum(rest) / 1e3):.0f} samples/s after the first; "
          f"wall {wall:.2f} s; epsilon {eps[-1]:.6f}; losses G {losses[0]:.4f} D {losses[1]:.4f}")
    return launches, k1_epoch_ms


def mnist_run_checked(tr, epochs):
    """(epsilon by epoch, the last logged losses) of an MNIST Trainer's
    run; fails unless each is finite (epsilon > 0, one an epoch) and so is
    every param."""
    import torch
    out = Path(tr.opt.output_dir)
    with open(out / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    losses = [float(rows[-1][k]) for k in ("G Adv Loss", "D Adv Loss", "D Real Loss",
                                           "D Fake Loss", "D Real Aux Loss")]
    if len(eps) != epochs or not all(math.isfinite(x) and x > 0 for x in eps):
        fail(f"bad epsilon column {eps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses {losses}")
    state_ok = all(torch.isfinite(t).all() for t in tr.state.d_params.values()) and \
        all(torch.isfinite(t).all() for t in tr.state.g_params.values())
    if not state_ok:
        fail("non-finite params after training")
    return eps, losses


def write_idx_gz(path, arr) -> None:
    """``arr`` (uint8) as an IDX file (magic 0x08, ndim), gzipped at level
    0: stored blocks, which any gzip reader takes, written and read several
    times faster than at level 1."""
    import gzip
    import struct
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    with gzip.open(path, "wb", compresslevel=0) as fh:
        fh.write(head + arr.astype("uint8").tobytes())


def write_mnist_mirror(root: Path, arrays: dict) -> str:
    """A local MNIST mirror: ``arrays`` ({file name: uint8 array}) as IDX
    .gz files in a new ``root``. Returns its ``file://`` URL, with the
    trailing slash that a mirror's URL has."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for name, arr in arrays.items():
        write_idx_gz(root / (name + ".gz"), arr)
    return root.as_uri() + "/"


def quantized_mnist() -> dict:
    """{IDX file name: uint8 array} of the arrays that the MNIST flagship
    loads (the port's synthetic set where its data path holds no MNIST;
    under ``mnist_made_once`` the train split comes from its cache), the
    pixels quantized to uint8 (round(x * 255))."""
    import numpy as np
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.data import mnist
    arrays = {}
    for train, (img, lbl) in mnist._RAW_NAMES.items():
        x, y = mnist.load_mnist(toptions.MNIST_DEFAULTS["data_path"], train=train)
        arrays[img] = np.rint(x[..., 0] * 255.0).astype(np.uint8)
        arrays[lbl] = y.astype(np.uint8)
    return arrays


@timed
def mnist_download_phase(out_root, smi):
    """The MNIST flagship (one epoch) under ``--download_mnist`` into an
    empty data directory, the port's mirrors swapped for two ``file://``
    URLs: a directory that does not exist, then a mirror written here
    (``write_mnist_mirror``) from ``quantized_mnist``. Fails unless the four
    files land in ``<data>/MNIST/raw`` byte for byte, after the missing mirror was tried
    for each, the Trainer's dataset and device table are the mirror's bytes
    / 255, K1 launches once and epsilon and the losses are finite."""
    import shutil
    import urllib.request
    import numpy as np
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.data import mnist
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.training.loop import Trainer

    t0 = time.perf_counter()
    root = out_root / "download"
    names = [n for pair in mnist._RAW_NAMES.values() for n in pair]
    arrays = quantized_mnist()
    mirrors = ((root / "no_such_mirror").as_uri() + "/",
               write_mnist_mirror(root / "mirror", arrays))
    data = root / "data"
    shutil.rmtree(data, ignore_errors=True)
    tried, retrieve = [], urllib.request.urlretrieve

    def recorded(url, *a, **kw):
        tried.append(url)
        return retrieve(url, *a, **kw)
    t_mirror = time.perf_counter() - t0
    with _swapped(((mnist, "_MIRRORS", mirrors), (urllib.request, "urlretrieve", recorded))):
        opt = toptions.parse(MNIST_FLAGSHIP + ["-ne", "1", "--log_every", "60000",
                                               "--manual_seed", "1", "--download_mnist",
                                               "-d", str(data), "-o", str(root / "train")])
        tr = Trainer(opt)
    raw = data / "MNIST" / "raw"
    want = [m + n + ".gz" for n in names for m in mirrors]
    if tried != want:
        fail(f"--download_mnist fetched {tried}, expected {want}")
    landed = sorted(p.name for p in raw.iterdir()) if raw.is_dir() else []
    if landed != sorted(n + ".gz" for n in names) or any(
            (raw / (n + ".gz")).read_bytes() != (root / "mirror" / (n + ".gz")).read_bytes()
            for n in names):
        fail(f"--download_mnist left {landed} in {raw}, not the mirror's four files")
    want_x, want_y = mnist.stratified_subset(
        arrays[names[0]][..., None].astype(np.float32) / 255.0,
        arrays[names[1]].astype(np.int64), opt.train_set_size)
    table = torch.from_numpy(want_x.reshape(len(want_x), -1)).to(tr.table.device)
    if not (np.array_equal(tr.dataset.images, want_x)
            and np.array_equal(tr.dataset.labels, want_y)
            and torch.equal(tr.table[:, :F], table.to(tr.table.dtype))):
        fail("the Trainer's MNIST rows are not the downloaded files' bytes / 255")
    pe.epoch_kernel.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    launches = pe.epoch_kernel.launches
    if launches != 1:
        fail(f"K1 launched {launches} times on the downloaded MNIST's epoch, expected 1")
    eps, losses = mnist_run_checked(tr, 1)
    print(f"MNIST --download_mnist ({smi}): 4 files from the second of 2 file:// mirrors "
          f"into {raw.relative_to(out_root)}, {len(tr.dataset)} rows = the mirror's bytes / 255; "
          f"K1 launches {launches}; epsilon {eps[-1]:.6f}; losses G {losses[0]:.4f} D "
          f"{losses[1]:.4f}; wall {time.perf_counter() - t0:.2f} s (mirror written "
          f"{t_mirror:.2f} s, set-up with the download {t1 - t0 - t_mirror:.2f} s, epoch "
          f"{time.perf_counter() - t1:.2f} s)")


@timed
def k1_timing_phase(dev, out_root, peak_flops, peak_bytes, launches, max_abs):
    """K1 and its plain version timed on one 100-step epoch at the MNIST
    path's shapes, and K1's device time by kernel and by product group.
    Returns K1's kernels-line entry."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from csl_gan_tpu_torch.ops import pallas_epoch as pe

    n = TIME_STEPS
    b = mnist_builder(dev, out_root, True, "time")
    ins = mnist_inputs(dev, b, n, True, seed=12)
    pe.epoch_kernel(b, *ins)                        # warm-up
    times = []
    for _ in range(3):
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        pe.epoch_kernel(b, *ins)
        s1.record()
        torch.cuda.synchronize()
        times.append(s0.elapsed_time(s1))
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    pe.epoch_plain(b, *ins)
    s1.record()
    torch.cuda.synchronize()
    plain_ms = s0.elapsed_time(s1)
    p_d = sum(t.numel() for t in ins[7][:6])
    p_g = sum(t.numel() for t in ins[7][6:])
    flops, nbytes = k1_flops(n), k1_bytes(n, p_d, p_g, True)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    ms = min(times)
    print(f"K1 epoch of {n} steps: kernel {ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in times)}), "
          f"plain {plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
          f"({flops / 1e9:.1f} GFLOP at {peak_flops / 1e12:g} TFLOP/s fp32; "
          f"{nbytes / 1e6:.1f} MB at {peak_bytes / 1e12:g} TB/s)")
    # Device time by CUDA kernel over one K1 epoch (torch.profiler / CUPTI).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0.record()
        pe.epoch_kernel(b, *ins)
        s1.record()
        torch.cuda.synchronize()
    span = s0.elapsed_time(s1)
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(r[0] for r in by_kernel)
    n_launch = sum(r[1] for r in by_kernel)
    print(f"profile: device busy {busy:.3f} ms of a {span:.3f} ms epoch "
          f"({100 * busy / span:.1f}%), {n_launch} CUDA launches ({n_launch / n:g} per step), "
          f"by kernel (ms, launches, name):")
    for t_ms, cnt, key in by_kernel[:16]:
        print(f"  {t_ms:9.3f} {cnt:6d}  {key}")
    groups = {}
    for t_ms, cnt, key in by_kernel:
        g = groups.setdefault(k1_group(key), [0.0, 0])
        g[0] += t_ms
        g[1] += cnt
    print("K1 profile by product group (device ms per epoch, launches per step): " + "; ".join(
        f"{g} {t:.3f} ({c / n:g})" for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    return {
        "name": "k1_epoch", "route": "cuda",
        "source": "csl_gan_tpu_torch/ops/csrc/k1_epoch.cu",
        "replaces": "csl_gan_tpu/ops/pallas_epoch.py:184",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "per": f"epoch of {n} steps", "device_ms": busy,
        "cuda_launches_per_step": n_launch / n,
    }


# ---------------- the CelebA path (K2-K5) ----------------

CB = 128                                   # the flagship's batch
# The D's ghost-order layers (conv2-conv4): (H of the input, Cin, Cout); 5x5,
# stride 2, pad 2 (models/dcresnet.py celeba_d64).
CONV_LAYERS = ((32, 64, 128), (16, 128, 256), (8, 256, 512))
# The G's norms: (HW, C) and how many of the nine layers have that shape.
GN_SHAPES = ((16, 512, 1), (64, 512, 2), (256, 256, 2), (1024, 128, 2), (4096, 64, 2))
FLAGSHIP = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(CB), "-tss", "12800",
            "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
            "--train_d_until_threshold", "1e18"]
# One epoch: a second gave only its ms per D step, a time with no limit.
CELEBA_EPOCHS = 1
# K2/K3 vs plain: the same bf16 inputs, exact fp32 products, fp32 sums in
# another order (and K3 rounds w * c to bf16 exactly as the plain version
# does), so the gap is reduction order: ~1e-7 to 1e-5 relative with FFMA
# sums and up to ~2e-5 with the tensor cores' fp32 accumulation (H100). A
# wrong term or a dropped tile moves it to >= 1e-3.
CONV_BOUND = 1e-4
# A bf16 geometry whose S, K and O are no multiples of the tensor-core tiles
# (B, H, Cin, Cout; 5x5, stride 2, pad 2), and the batch of the fp32 check.
CONV_RAGGED = (7, 16, 24, 40)
CONV_FP32_BATCH = 8
# K4/K5 vs plain: fp32 statistics in another summation order; the bf16
# outputs (y, dx) then round to the other side of a bf16 step on rare
# elements (one ulp, 2^-8 relative), ~2e-5 in relative l2 (H100). dgamma /
# dbeta are fp32 sums: reduction order only.
GN_BOUND, GN_PARAM_BOUND = 1e-3, 1e-4
# The fp32 kernel check runs the G's norms at the fp32 step check's batch;
# the ragged geometries ([B, HW, C]) take odd cuts (a 7-CTA cluster, a last
# CTA with fewer rows, one row per sample) and the two-pass variant (the
# last: 8 MiB of bf16 a sample).
GN_FP32_BATCH = 8
# A ReLU mask flip: where the fp32 pre-activation z lies within rounding of
# 0, the two summation orders of the statistics can put it on either side,
# and the element's whole dy then enters dbeta on one side only (one such
# element at z ~ 3e-8 moved dbeta by 9.2e-4 in relative l2 at [2, 4096,
# 1024] bf16, B 2; H100).
# K5 is held on dy zeroed where the plain version's |z| <= GN_EDGE times z's
# rms (the same dy on both sides; ~2^-16 of the elements), far above the
# ~1e-6 that the orders move z by; the raw gaps are printed beside.
GN_EDGE = 2.0 ** -16
GN_RAGGED = ((3, 49, 32), (5, 1, 1024), (3, 49, 1024), (3, 2500, 64), (2, 4096, 1024))
# One full-width D step and G step on the card (fp32, TF32 off, deterministic
# cuDNN) through K2-K5 against the same steps through the plain versions; the
# plain steps repeat exactly, so only K2-K5 differ. On an H100 the D step's
# params and moments differ by ~1e-5 (reduction order) and the metrics by
# ~1e-6. G's gradient is far more sensitive: its ReLU masks and D's
# leaky-ReLU masks flip on the few elements within rounding of 0, and moving
# z by 1e-7 relative moves G's moments by ~7e-3, twice the ~4e-3 that K2-K5
# move them by. So G is held to 2e-2, under 3x that witness, which the check
# prints on every run. A fault in the wiring (a layer, a factor, a scale)
# moves them by O(1).
STEP_BOUND_D, STEP_BOUND_G, STEP_BOUND_MET = 1e-4, 2e-2, 1e-4
# The D step's fakes are the G forward through K4; D's gradient is not
# continuous in them (leaky-ReLU masks, within rounding of 0 on a few
# elements): K4 moves the fp32 fakes by ~2.5e-6, as much as z moved by 1e-7
# does, and that moved the plain D step by 2.7e-4 in its params (H100),
# above STEP_BOUND_D. So the D step is compared on the same fakes on both
# sides (those of the kernel side), and the fakes themselves, continuous in
# K4's outputs, are held to STEP_BOUND_FAKES (a wrong term moves them by O(1)).
STEP_BOUND_FAKES = 1e-4
# The bf16 step through K2-K5 against the all-plain bf16 step. K4/K5's bf16
# outputs differ from their plain versions' by one ulp on rare elements,
# and the bf16 step amplifies that (~3e-2 on D's moments, ~9e-2 on G's;
# H100). Its witness, computed on every run, is that fault and no more: the
# all-plain step with the output of each K4/K5 call (y, dx) moved by one ulp,
# up or down, on a random share of its non-zero elements, the share that
# K4/K5's call at the same place in the kernel step moved (measured there
# against the plain version on the same inputs). A z moved by 2^-8 instead
# moves almost every element and gave a witness 2-8x the gap (H100). Each
# group (D params, D mu, D nu, G mu, G nu, the metrics) is held to
# STEP_BF16_FACTOR times the witness's value for that group; a wrong layer,
# factor or scale in K4/K5 moves the step by O(1).
STEP_BF16_FACTOR = 3.0


# ---------------- the materialized paths (K6) ----------------

PATH1 = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
         "-tss", "60000", "--pallas", "true", "--grad_clip_split", "false"]
PATH2 = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(CB), "-tss", "1280",
         "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
         "--train_d_until_threshold", "1e18", "--conv_ghost", "false", "--pallas", "true"]
K6_EPOCHS = 1                  # as CELEBA_EPOCHS
K6_STD = 2.5
# K6 vs plain. The sum: the same fp32 products added in another order (K6:
# ascending rows per split, then the splits; plain: cuBLAS), ~1e-7 relative
# (H100). The noise: both compute the same Philox words exactly and the same
# Box-Muller in fp32, whose logf / cosf may differ by an ulp between the two
# compilers' math libraries: ~1e-6 * std. So with one seed the results are
# held to 1e-4 * std absolute (the sum's gap included: inputs are N(0, 1)
# rows and weights in [0.1, 1]), which a wrong counter, key or uniform (an
# independent draw, gap ~ std) fails by four orders of magnitude.
K6_SUM_BOUND, K6_NOISE_BOUND = 1e-5, 1e-4
# One full-width D step through K6 against the same step through K6's plain
# version, same seeds (deterministic cuDNN): only the sum's order differs, so
# D's params and moments are held like the CelebA step check's; the metrics
# are taken before the update and must not move at all beyond that bound.
K6_STEP_BOUND = 1e-4
# The ghost-clipped real sum against the materialized one (fp32, TF32 off):
# analytic norms and matrix products against vmap(grad) and K6's sum.
GHOST_BOUND = 1e-4

# The CUDA kernels of K4 / K5 (csrc/gn_relu.cu).
GN_KERNELS = ("gn_fwd_cluster", "gn_bwd_cluster", "gn_param_grads", "gn_chunk_stats",
              "gn_sample_stats", "gn_apply", "gn_bwd_chunk", "gn_bwd_sample", "gn_bwd_dx")
# CUDA kernel names by group, for the step profiles; the first match wins.
PROFILE_GROUPS = (
    ("K6 clip_noise", ("k6_registers",)),
    ("K2 ghost_sq_norms", ("ghost_norm_tc", "ghost_norm_tiles", "sum_rows")),
    ("K3 weighted_kernel_grad", ("wsum_tc", "scale_cotangent", "wsum_tiles", "sum_splits")),
    ("K4/K5 gn_relu", GN_KERNELS),
    ("cuDNN convolutions", ("implicit_gemm", "cudnn", "fprop", "dgrad", "wgrad")),
    ("cuBLAS GEMMs", ("gemm", "gemv")),
    ("im2col (conv1's direct order)", ("im2col",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("other element-wise", ("elementwise",)),
)


def device_ms_by_kernel(prof):
    """[(device ms, launches, name)] of each CUDA kernel in a torch.profiler
    run, largest first (operator rows and the profiler's step annotation,
    which repeat their kernels' time, are left out)."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type) or ev.key.startswith("ProfilerStep"):
            continue
        t_dev = getattr(ev, "self_device_time_total", None)
        if t_dev is None:
            t_dev = getattr(ev, "self_cuda_time_total", 0)
        if t_dev > 0:
            rows.append((t_dev / 1e3, ev.count, ev.key[:110]))
    return sorted(rows, reverse=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    for _ in range(reps):
        fn()
    s1.record()
    torch.cuda.synchronize()
    return s0.elapsed_time(s1) / reps


def traced_calls(fn, reps: int):
    """device_ms_by_kernel of a torch.profiler window of reps calls of fn,
    after one more call that the profiler traces and discards (a warm-up
    step): on an H100, a short window opened after a process has run a while
    has been seen to lose its first kernel's record in every try, and the
    warm-up step takes that loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return device_ms_by_kernel(prof)


def device_ms(fn, reps: int):
    """Device time of fn by CUDA kernel over reps calls (torch.profiler /
    CUPTI): (sum of the kernels' ms per call, {kernel name: ms per call},
    {kernel name: launches per call})."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # a trace now and then comes back empty
        rows = traced_calls(fn, reps)
        if rows and all(cnt % reps == 0 for _, cnt, _ in rows):
            by = {key: t / reps for t, _, key in rows}
            return sum(by.values()), by, {key: cnt // reps for _, cnt, key in rows}
    fail("torch.profiler recorded no complete device trace in 5 tries")


def ptxas_by_kernel(log: str):
    """{demangled-enough kernel name: "N registers, ... spill ..."} from a
    ptxas -v report."""
    out, name, frame = {}, None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            frame = line
        elif line.startswith("ptxas info") and "Used" in line and name:
            out[name] = f"{line.split(':', 1)[1].strip()}; {frame}"
            name = None
    return out


def bound(ops: float, nbytes: float, peak_ops: float, peak_bytes: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bytes * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_ops(b: int, s: int, k: int, o: int) -> float:
    """Operations that B per-sample norms ||U_i^T C_i||^2 need at least: the
    cheaper of the symmetric half of both [S, S] Grams with their Frobenius
    product, and the direct order (each [K, O] product, then its squares)."""
    grams = float(b) * s * (s + 1) * (k + o + 1)
    direct = 2.0 * b * k * o * (s + 1)
    return min(grams, direct)


def conv_operands(g, dev, b, h, cin, cout, dtype):
    """Random K2 / K3 operands of a 5x5 stride-2 conv: (a, c, w, kernel shape)."""
    import torch
    ho = (h + 4 - 5) // 2 + 1
    a = torch.randn(b, h, h, cin, generator=g, device=dev).to(dtype)
    c = torch.randn(b, ho, ho, cout, generator=g, device=dev).to(dtype)
    w = torch.rand(b, generator=g, device=dev) * 0.9 + 0.1
    return a, c, w, (5, 5, cin, cout)


def conv_held(tag, a, c, w, ks, want):
    """K2 and K3 against their plain versions to CONV_BOUND; the variant they
    took must be `want`. Returns (rel l2 K2, K3, max abs gap K2, K3)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    before = (pcg.ghost_sq_norms.launches_tc, pcg.weighted_kernel_grad.launches_tc)
    nk, npl = pcg.ghost_sq_norms(a, c, 5, 5, 2, 2), pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2)
    wk = pcg.weighted_kernel_grad(a, c, w, ks, 2, 2)
    wp = pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2)
    torch.cuda.synchronize()
    took = (pcg.ghost_sq_norms.launches_tc - before[0],
            pcg.weighted_kernel_grad.launches_tc - before[1])
    r2, r3 = rel_l2(nk, npl), rel_l2(wk, wp)
    if took != ((1, 1) if want == "tc" else (0, 0)):
        fail(f"K2/K3 did not take the {want} variant at {tag}")
    if not (r2 < CONV_BOUND and r3 < CONV_BOUND):
        fail(f"K2/K3 ({want}) disagree with their plain versions at {tag}: "
             f"rel l2 {r2:.3e}, {r3:.3e}")
    return r2, r3, float((nk - npl).abs().max()), float((wk - wp).abs().max())


@timed
def conv_ghost_phase(dev, peak_bf16, peak_bytes):
    """K2 / K3 against their plain versions: the tensor-core variant at
    conv2-conv4 (bf16, B 128) and at a ragged bf16 geometry, the FFMA variant
    at conv2-conv4 with fp32 operands; then both variants timed in turns."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg

    g = torch.Generator(dev).manual_seed(21)

    def operands(b, h, cin, cout, dtype):
        return conv_operands(g, dev, b, h, cin, cout, dtype)

    held = conv_held

    b, h, cin, cout = CONV_RAGGED
    r2, r3, _, _ = held("the ragged geometry", *operands(b, h, cin, cout, torch.bfloat16), "tc")
    print(f"conv ragged [{b}, {h}, {h}, {cin}]->{cout} bf16, tensor cores: K2 rel l2 {r2:.3e}, "
          f"K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")
    for h, cin, cout in CONV_LAYERS:
        r2, r3, _, _ = held(f"fp32 conv {h}x{h}x{cin}->{cout}",
                            *operands(CONV_FP32_BATCH, h, cin, cout, torch.float32), "ffma")
        print(f"conv {h}x{h}x{cin}->{cout} fp32 (B {CONV_FP32_BATCH}), FFMA: K2 rel l2 {r2:.3e}, "
              f"K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")

    keys = ("k2", "k2_ffma", "k2_dev", "k2_plain", "k3", "k3_ffma", "k3_dev", "k3_pre_dev",
            "k3_plain", "k3_lib", "k3_lib_dev", "k2_ops", "k2_bytes", "k3_ops", "k3_bytes")
    tot = {k: 0.0 for k in keys}
    err = {"k2": 0.0, "k3": 0.0}
    for h, cin, cout in CONV_LAYERS:
        ho = h // 2
        a, c, w, ks = operands(CB, h, cin, cout, torch.bfloat16)
        r2, r3, e2, e3 = held(f"conv {h}x{h}x{cin}->{cout}", a, c, w, ks, "tc")
        err["k2"], err["k3"] = max(err["k2"], e2), max(err["k3"], e3)
        # Library yardstick of K3: cuDNN's weight gradient of the conv on the
        # w-scaled bf16 cotangent (the scaling is not timed).
        a_nchw = a.permute(0, 3, 1, 2)
        cw = (c.float() * w[:, None, None, None]).to(torch.bfloat16).permute(0, 3, 1, 2)
        wshape = (cout, cin, 5, 5)
        k2 = lambda v: (lambda: pcg.ghost_sq_norms(a, c, 5, 5, 2, 2, variant=v))  # noqa: E731
        k3 = lambda v: (lambda: pcg.weighted_kernel_grad(a, c, w, ks, 2, 2, variant=v))  # noqa: E731
        lib = lambda: torch.nn.grad.conv2d_weight(a_nchw, wshape, cw, 2, 2)  # noqa: E731
        # In turns within this call: FFMA, tensor cores, tensor cores, FFMA.
        turns = {key: [cuda_ms(fn(v), 10) for v in ("ffma", "tc", "tc", "ffma")]
                 for key, fn in (("k2", k2), ("k3", k3))}
        t = {"k2": sum(turns["k2"][1:3]) / 2, "k2_ffma": (turns["k2"][0] + turns["k2"][3]) / 2,
             "k3": sum(turns["k3"][1:3]) / 2, "k3_ffma": (turns["k3"][0] + turns["k3"][3]) / 2,
             "k2_plain": cuda_ms(lambda: pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2), 5),
             "k3_plain": cuda_ms(lambda: pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2), 5),
             "k3_lib": cuda_ms(lib, 10)}
        t["k2_dev"], *_ = device_ms(k2("tc"), 10)
        t["k3_dev"], by3, _ = device_ms(k3("tc"), 10)
        t["k3_pre_dev"] = sum(v for k, v in by3.items() if "scale_cotangent" in k)
        t["k3_lib_dev"], *_ = device_ms(lib, 10)
        s, k = ho * ho, 25 * cin
        in_bytes = (a.numel() + c.numel()) * 2
        t.update(k2_ops=k2_ops(CB, s, k, cout), k2_bytes=in_bytes + CB * 4,
                 k3_ops=2.0 * CB * s * k * cout, k3_bytes=in_bytes + CB * 4 + k * cout * 4)
        for key, v in t.items():
            tot[key] += v
        rate = lambda ops, ms: (f"{ops / ms / 1e9:.1f} TFLOP/s, "  # noqa: E731
                                f"{100 * ops / peak_bf16 * 1e3 / ms:.1f}% of the bf16 bound")
        print(f"conv {h}x{h}x{cin}->{cout} bf16 (B {CB}), tensor cores: K2 rel l2 {r2:.3e}, K3 rel "
              f"l2 {r3:.3e} (bound {CONV_BOUND:g})")
        print(f"  K2 ms by CUDA events, in turns FFMA/tc/tc/FFMA: "
              f"{', '.join(f'{x:.4f}' for x in turns['k2'])}; tensor cores {t['k2']:.4f} "
              f"(device {t['k2_dev']:.4f}: {rate(t['k2_ops'], t['k2_dev'])}), FFMA "
              f"{t['k2_ffma']:.4f}, plain {t['k2_plain']:.3f}")
        print(f"  K3 ms by CUDA events, in turns FFMA/tc/tc/FFMA: "
              f"{', '.join(f'{x:.4f}' for x in turns['k3'])}; tensor cores {t['k3']:.4f} "
              f"(device {t['k3_dev']:.4f}, the pre-pass {t['k3_pre_dev']:.4f} of it: "
              f"{rate(t['k3_ops'], t['k3_dev'])}), FFMA {t['k3_ffma']:.4f}, plain "
              f"{t['k3_plain']:.3f}, conv2d_weight {t['k3_lib']:.4f} (device {t['k3_lib_dev']:.4f})")
        del a, c, a_nchw, cw
    b2, by2 = bound(tot["k2_ops"], tot["k2_bytes"], peak_bf16, peak_bytes)
    b3, by3 = bound(tot["k3_ops"], tot["k3_bytes"], peak_bf16, peak_bytes)
    per = "D step (conv2 + conv3 + conv4)"
    print(f"K2 / K3 per {per}, ms: K2 tensor cores {tot['k2']:.4f} by CUDA events, "
          f"{tot['k2_dev']:.4f} on the device (bound {b2:.4f}, {by2}), FFMA {tot['k2_ffma']:.4f}; "
          f"K3 tensor cores {tot['k3']:.4f} by CUDA events, {tot['k3_dev']:.4f} on the device "
          f"(pre-pass {tot['k3_pre_dev']:.4f} of it; bound {b3:.4f}, {by3}), FFMA "
          f"{tot['k3_ffma']:.4f}, conv2d_weight {tot['k3_lib']:.4f} by CUDA events, "
          f"{tot['k3_lib_dev']:.4f} on the device")
    return [
        {"name": "ghost_sq_norms", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/conv_ghost.cu",
         "replaces": "csl_gan_tpu/ops/pallas_conv_ghost.py:170",
         "max_abs_err": err["k2"], "ms": tot["k2"], "plain_ms": tot["k2_plain"],
         "bound_ms": b2, "bound_by": by2, "library_ms": None, "per": per,
         "variant": "tc", "device_ms": tot["k2_dev"], "ffma_ms": tot["k2_ffma"]},
        {"name": "weighted_kernel_grad", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/conv_ghost.cu",
         "replaces": "csl_gan_tpu/ops/pallas_conv_ghost.py:234",
         "max_abs_err": err["k3"], "ms": tot["k3"], "plain_ms": tot["k3_plain"],
         "bound_ms": b3, "bound_by": by3, "library_ms": tot["k3_lib"], "per": per,
         "variant": "tc", "device_ms": tot["k3_dev"], "ffma_ms": tot["k3_ffma"],
         "library_device_ms": tot["k3_lib_dev"]}]


def bf16_ulp_counts(k, p):
    """(elements of k beyond one bf16 ulp of p, elements one ulp off, ReLU-
    boundary elements beyond one ulp, left out) for bf16 outputs. One ulp is
    that of the larger magnitude of the two; left out are elements where both
    values lie within one bf16 ulp of 0 at the layer's scale (the ulp of p's
    rms)."""
    import torch
    kf, pf = k.float(), p.float()
    big = torch.maximum(kf.abs(), pf.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    rms = pf.pow(2).mean().sqrt().cpu()
    diff = (kf - pf).abs()
    edge = big <= float(torch.ldexp(torch.ones(()), torch.frexp(rms).exponent - 8))
    off = diff > ulp
    return (int((off & ~edge).sum()), int(((diff > 0) & ~off).sum()), int((off & edge).sum()))


def gn_operands(g, dev, b, hw, c, dtype):
    """Random K4 / K5 operands [B, HW, C]: (x, dy, scale, bias)."""
    import torch
    x = (torch.randn(b, hw, c, generator=g, device=dev) * 2 + 0.3).to(dtype)
    dy = torch.randn(b, hw, c, generator=g, device=dev).to(dtype)
    sc = torch.randn(c, generator=g, device=dev) * 0.2 + 1.0
    bi = torch.randn(c, generator=g, device=dev) * 0.1
    return x, dy, sc, bi


def gn_held(x, dy, sc, bi, groups=32):
    """K4 and K5 against their plain versions (GN_BOUND, GN_PARAM_BOUND) and
    against themselves, at ``groups`` groups; returns (plans, max abs gaps
    of K4 and K5)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    b, hw, c = x.shape
    tag = f"[{b}, {hw}, {c}] {str(x.dtype).replace('torch.', '')}" + (
        f", {groups} groups" if groups != 32 else "")
    G = groups
    (p4, occ4), (p5, occ5) = gn.occupancy(x, G, False), gn.occupancy(x, G, True)
    if min(occ4, occ5) <= 0:
        fail(f"a K4/K5 plan cannot be resident at {tag}: {p4} ({occ4}), {p5} ({occ5})")
    _, _, a, d = gn._affine(x.float(), sc, bi, G, 1e-5)
    z = x.float() * a[:, None, :] + d[:, None, :]
    edge = z.abs() <= GN_EDGE * z.pow(2).mean().sqrt()
    raw = [gn.gn_relu_backward(x, dy, sc, bi, G, 1e-5),
           gn.gn_relu_bwd_plain(x, dy, sc, bi, G, 1e-5)]
    dy = torch.where(edge, torch.zeros_like(dy), dy)
    del z, a, d
    yk, yp = gn.gn_relu_forward(x, sc, bi, G, 1e-5), gn.gn_relu_plain(x, sc, bi, G, 1e-5)
    bk = gn.gn_relu_backward(x, dy, sc, bi, G, 1e-5)
    bp = gn.gn_relu_bwd_plain(x, dy, sc, bi, G, 1e-5)
    y2 = gn.gn_relu_forward(x, sc, bi, G, 1e-5)
    b2 = gn.gn_relu_backward(x, dy, sc, bi, G, 1e-5)
    # K5's ReLU mask against K4's: with dy = 1, dbeta counts the elements
    # K5 lets through, exactly in fp32, and y > 0 those K4 let through.
    ones = gn.gn_relu_backward(x, torch.ones_like(dy), sc, bi, G, 1e-5)[2]
    mask_same = torch.equal(ones, (yk > 0).sum(dim=(0, 1)).float())
    torch.cuda.synchronize()
    r4 = rel_l2(yk.float(), yp.float())
    r5 = rel_l2(bk[0].float(), bp[0].float())
    rp = max(rel_l2(bk[1], bp[1]), rel_l2(bk[2], bp[2]))
    r5_raw = rel_l2(raw[0][0].float(), raw[1][0].float())
    rp_raw = max(rel_l2(raw[0][1], raw[1][1]), rel_l2(raw[0][2], raw[1][2]))
    same = torch.equal(yk, y2) and all(torch.equal(u, v) for u, v in zip(bk, b2))
    del raw
    def kind(p):
        return "one pass, cluster" if p[0] == gn.ONE_PASS else "two pass, chunk"
    line = (f"groupnorm+relu {tag}: K4 rel l2 {r4:.3e}, K5 dx rel l2 {r5:.3e} (bound "
            f"{GN_BOUND:g}), dgamma/dbeta {rp:.3e} (bound {GN_PARAM_BOUND:g}); twice "
            f"{'bitwise equal' if same else 'DIFFERENT'}; K5's ReLU mask "
            f"{'is' if mask_same else 'is NOT'} K4's; dy zeroed at {int(edge.sum())} "
            f"ReLU-edge elements (raw: dx {r5_raw:.3e}, dgamma/dbeta {rp_raw:.3e}); plans "
            f"(variant, n, rows, threads, smem) K4 {p4} {kind(p4)} {p4[1]}, resident "
            f"{occ4}; K5 {p5} {kind(p5)} {p5[1]}, resident {occ5}")
    if x.dtype == torch.bfloat16:
        u4, u5 = bf16_ulp_counts(yk, yp), bf16_ulp_counts(bk[0], bp[0])
        line += (f"; bf16 elements beyond one ulp (one ulp off; both within an ulp of 0, "
                 f"left out): y {u4[0]} ({u4[1]}; {u4[2]}), dx {u5[0]} ({u5[1]}; {u5[2]}) "
                 f"of {x.numel()}")
        if u4[0] or u5[0]:
            fail(f"K4/K5 outputs beyond one bf16 ulp of their plain versions at {tag}")
    print(line)
    if not (r4 < GN_BOUND and r5 < GN_BOUND and rp < GN_PARAM_BOUND):
        fail(f"K4/K5 disagree with their plain versions at {tag}")
    if not same:
        fail(f"K4/K5 are not bitwise repeatable at {tag}")
    if not mask_same:
        fail(f"K5's ReLU mask is not the one K4 applied at {tag}")
    e4 = float((yk.float() - yp.float()).abs().max())
    e5 = max(float((u.float() - v.float()).abs().max()) for u, v in zip(bk, bp))
    return p4, p5, e4, e5


@timed
def groupnorm_phase(dev, peak_bytes):
    """K4 / K5 against their plain versions: bf16 at the G's norms (B 128,
    timed), fp32 at the same norms (B 8) and at the flagship's first norm
    (the G's dense output is fp32), both dtypes at the ragged geometries;
    each launch plan and its residency printed, each pair run twice (bitwise
    equal), K5's ReLU mask held to K4's, bf16 outputs counted in ulps, CUDA
    launches a call counted in a profiler trace."""
    import torch
    import torch.nn.functional as fn
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    g = torch.Generator(dev).manual_seed(22)

    def operands(b, hw, c, dtype):
        return gn_operands(g, dev, b, hw, c, dtype)

    held = gn_held

    for b, hw, c in GN_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            p4, p5, _, _ = held(*operands(b, hw, c, dtype))
            if (b, hw, c) == GN_RAGGED[-1] and (p4[0], p5[0]) != (gn.TWO_PASS, gn.TWO_PASS):
                fail(f"[{b}, {hw}, {c}] did not take the two-pass variant")
    for hw, c, _ in GN_SHAPES:
        held(*operands(GN_FP32_BATCH, hw, c, torch.float32))
    x, dy, sc, bi = operands(CB, 16, 512, torch.float32)
    held(x, dy, sc, bi)
    print(f"  the flagship's first norm, fp32 [{CB}, 16, 512]: K4 "
          f"{cuda_ms(lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5), 20):.4f} ms, K5 "
          f"{cuda_ms(lambda: gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5), 20):.4f} ms")

    keys = ("k4", "k4_dev", "k4_plain", "k4_lib", "k5", "k5_dev", "k5_plain", "k5_lib",
            "k4_bytes", "k5_bytes", "k4_launches", "k5_launches")
    tot = {k: 0.0 for k in keys}
    err = {"k4": 0.0, "k5": 0.0}
    plans = []
    for hw, c, mult in GN_SHAPES:
        x, dy, sc, bi = operands(CB, hw, c, torch.bfloat16)
        p4, p5, e4, e5 = held(x, dy, sc, bi)
        plans.append({"shape": [CB, hw, c], "norms": mult, "k4": list(p4), "k5": list(p5)})
        err["k4"], err["k5"] = max(err["k4"], e4), max(err["k5"], e5)
        # Library yardsticks on an NCHW copy (bf16 affine; the copies are not
        # timed): K4's, F.group_norm then relu; K5's, the autograd backward
        # of the same two ops (backward only).
        xc = x.transpose(1, 2).contiguous()
        dyc = dy.transpose(1, 2).contiguous()
        scb, bib = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        xr, sr, br = (t.detach().requires_grad_() for t in (xc, scb, bib))
        out = fn.relu(fn.group_norm(xr, 32, sr, br, 1e-5))
        k4 = lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5)  # noqa: E731
        k5 = lambda: gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5)  # noqa: E731
        (k4_dev, _, k4_n), (k5_dev, _, k5_n) = device_ms(k4, 10), device_ms(k5, 10)
        # CUDA launches per call, counted in the trace; the plan says how
        # many its variant makes (one pass: K4 1, K5 2; two pass: 3, 6).
        n4, n5 = (sum(v for k, v in by.items() if any(g in k for g in GN_KERNELS))
                  for by in (k4_n, k5_n))
        if (n4, n5) != (1 if p4[0] == gn.ONE_PASS else 3, 2 if p5[0] == gn.ONE_PASS else 6):
            fail(f"K4/K5 made {n4} / {n5} CUDA launches a call at [{CB}, {hw}, {c}] bf16, "
                 f"not the {p4} / {p5} plans' count")
        t = {"k4": cuda_ms(k4, 20), "k4_dev": k4_dev,
             "k4_plain": cuda_ms(lambda: gn.gn_relu_plain(x, sc, bi, 32, 1e-5), 5),
             "k4_lib": cuda_ms(lambda: fn.relu(fn.group_norm(xc, 32, scb, bib, 1e-5)), 20),
             "k5": cuda_ms(k5, 20), "k5_dev": k5_dev,
             "k5_plain": cuda_ms(lambda: gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5), 5),
             "k5_lib": cuda_ms(lambda: torch.autograd.grad(out, (xr, sr, br), dyc,
                                                           retain_graph=True), 20),
             "k4_bytes": 2 * x.numel() * 2 + 2 * c * 4,
             "k5_bytes": 3 * x.numel() * 2 + 4 * c * 4,
             "k4_launches": n4, "k5_launches": n5}
        for key, v in t.items():
            tot[key] += mult * v
        print(f"  x{mult} in the G: K4 {t['k4']:.4f} ms by CUDA events, {t['k4_dev']:.4f} on the "
              f"device (plain {t['k4_plain']:.3f}, group_norm+relu {t['k4_lib']:.4f}); K5 "
              f"{t['k5']:.4f} / {t['k5_dev']:.4f} (plain {t['k5_plain']:.3f}, backward of "
              f"group_norm+relu {t['k5_lib']:.4f})")
        del x, dy, xc, dyc, xr, sr, br, out
    # Element-wise arithmetic (~10 flop per element) is far below the bytes.
    b4, by4 = bound(0.0, tot["k4_bytes"], 1.0, peak_bytes)
    b5, by5 = bound(0.0, tot["k5_bytes"], 1.0, peak_bytes)
    per4, per5 = "G forward (nine norms)", "G backward (nine norms)"
    print(f"K4 per {per4}: {tot['k4']:.4f} ms by CUDA events, {tot['k4_dev']:.4f} on the device "
          f"(bound {b4:.4f}, {by4}; {100 * b4 / tot['k4_dev']:.1f}% of it on the device), "
          f"{tot['k4_launches']:g} CUDA launches (traced), plain {tot['k4_plain']:.3f}, group_norm+relu "
          f"{tot['k4_lib']:.4f}")
    print(f"K5 per {per5}: {tot['k5']:.4f} ms by CUDA events, {tot['k5_dev']:.4f} on the device "
          f"(bound {b5:.4f}, {by5}; {100 * b5 / tot['k5_dev']:.1f}% of it on the device), "
          f"{tot['k5_launches']:g} CUDA launches (traced), plain {tot['k5_plain']:.3f}, backward of "
          f"group_norm+relu {tot['k5_lib']:.4f}")
    return [
        {"name": "gn_relu_forward", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/gn_relu.cu",
         "replaces": "csl_gan_tpu/ops/pallas_groupnorm.py:111",
         "max_abs_err": err["k4"], "ms": tot["k4"], "plain_ms": tot["k4_plain"],
         "bound_ms": b4, "bound_by": by4, "library_ms": tot["k4_lib"], "per": per4,
         "device_ms": tot["k4_dev"], "cuda_launches_per_pass": tot["k4_launches"],
         "plans": [{"shape": p["shape"], "norms": p["norms"], "plan": p["k4"]} for p in plans]},
        {"name": "gn_relu_backward", "route": "cuda",
         "source": "csl_gan_tpu_torch/ops/csrc/gn_relu.cu",
         "replaces": "csl_gan_tpu/ops/pallas_groupnorm.py:119",
         "max_abs_err": err["k5"], "ms": tot["k5"], "plain_ms": tot["k5_plain"],
         "bound_ms": b5, "bound_by": by5, "library_ms": tot["k5_lib"], "per": per5,
         "library": "autograd backward of relu(F.group_norm)",
         "device_ms": tot["k5_dev"], "cuda_launches_per_pass": tot["k5_launches"],
         "plans": [{"shape": p["shape"], "norms": p["norms"], "plan": p["k5"]} for p in plans]}]


def gn_plans_phase(dev):
    """Every one-pass plan of K4 / K5 (n = 1, 2, 4, ..., 16 CTAs a cluster at
    128 and 256 threads) and the two-pass plan at the G's norms (B 128,
    bf16): device time, resident clusters and the gap to the plain version,
    the plan that launch_plan picks marked. Run with --gn-plans."""
    import ctypes

    import torch
    from csl_gan_tpu_torch.ops import _build
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    lib = _build.load("gn_relu")
    g = torch.Generator(dev).manual_seed(22)
    for hw, c, _ in GN_SHAPES:
        x = (torch.randn(CB, hw, c, generator=g, device=dev) * 2 + 0.3).to(torch.bfloat16)
        dy = torch.randn(CB, hw, c, generator=g, device=dev).to(torch.bfloat16)
        sc = torch.randn(c, generator=g, device=dev) * 0.2 + 1.0
        bi = torch.randn(c, generator=g, device=dev) * 0.1
        out = torch.empty_like(x)
        dg, db = torch.empty(c, device=dev), torch.empty(c, device=dev)
        geo = (ctypes.c_int * 4)(CB, hw, c, 32)
        st = torch.cuda.current_stream(dev).cuda_stream
        for bw in (False, True):
            ref = (gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5)[0] if bw
                   else gn.gn_relu_plain(x, sc, bi, 32, 1e-5))
            plans = [(gn.ONE_PASS, -(-hw // rows), rows, threads,
                      gn.one_pass_smem(rows, c, 32, 2, threads, bw))
                     for threads in (128, 256)
                     for rows in sorted({-(-hw // n) for n in (1, 2, 4, 8, 16) if n <= hw},
                                        reverse=True)]
            plans = [p for p in plans if p[4] <= gn.MAX_SMEM]
            plans.append((gn.TWO_PASS, 1, max(1, min(hw, gn.TWO_PASS_ELEMS // c)), 256,
                          gn.red_bytes(c, 2, 256)))
            for plan in plans:
                pl = (ctypes.c_int * 5)(*plan)
                scr = torch.empty(max(lib.gn_relu_scratch(geo, pl, 1, int(bw)), 1), device=dev)
                args = ((x.data_ptr(), dy.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                         out.data_ptr(), dg.data_ptr(), db.data_ptr()) if bw else
                        (x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr()))
                run = (lib.gn_relu_bwd if bw else lib.gn_relu_fwd)
                rc = run(*args, scr.data_ptr(), geo, pl, 1, 1e-5, st)
                if rc:
                    fail(f"plan {plan} at [{CB}, {hw}, {c}]: {lib.gn_error_string(rc).decode()}")
                ms, *_ = device_ms(lambda: run(*args, scr.data_ptr(), geo, pl, 1, 1e-5, st), 10)
                chosen = plan == gn.launch_plan(CB, hw, c, 32, torch.bfloat16, bw)
                print(f"  [{CB}, {hw}, {c}] {'K5' if bw else 'K4'} plan {plan}: device "
                      f"{ms:.4f} ms, resident {lib.gn_relu_occupancy(geo, pl, 1, int(bw))}, rel "
                      f"l2 to plain {rel_l2(out.float(), ref.float()):.2e}"
                      + (" (chosen)" if chosen else ""), flush=True)
        del x, dy, out


@contextlib.contextmanager
def _swapped(swaps):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_versions(groupnorm=True):
    """K2-K5's wrappers (K2/K3's only with groupnorm=False) replaced by their
    plain versions, so that a step on the card runs the same cuDNN
    convolutions without the kernels."""
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    swaps = ((pcg, "ghost_sq_norms", pcg.ghost_sq_norms_plain),
             (pcg, "weighted_kernel_grad", pcg.weighted_kernel_grad_plain),
             (gn, "gn_relu_forward", gn.gn_relu_plain),
             (gn, "gn_relu_backward", gn.gn_relu_bwd_plain))
    return _swapped(swaps if groupnorm else swaps[:2])


def plain_clip():
    """K6's wrapper replaced by its plain version (and nothing else: the G
    forward of the step goes on through K4 on both sides)."""
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    def clip_plain(gs, ws, seeds, stds, bases=None, slots=None):
        return pc.leaves_weighted_sum_noise_plain(gs, ws, seeds, stds, bases, slots)

    return _swapped(((pc, "leaves_weighted_sum_noise", clip_plain),))


def _share_moved(k, p):
    """The share of the elements of k that differ from p."""
    return float((k != p).sum()) / max(k.numel(), 1)


def gn_recorded(shares):
    """K4/K5's wrappers, each call also run through its plain version on the
    same inputs; appends the share of the output's elements (y; dx) that the
    kernel moved to shares["fwd"] / shares["bwd"], in call order, and returns
    the kernel's outputs."""
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    fwd, bwd = gn.gn_relu_forward, gn.gn_relu_backward

    def rec_fwd(x, sc, bi, groups, eps):
        y = fwd(x, sc, bi, groups, eps)
        plain = gn.gn_relu_plain(x, sc, bi, groups, eps)
        shares["fwd"].append(_share_moved(y, plain))
        if "fwd_gap" in shares:
            shares["fwd_gap"].append(rel_l2(y, plain))
        return y

    def rec_bwd(x, dy, sc, bi, groups, eps):
        out = bwd(x, dy, sc, bi, groups, eps)
        shares["bwd"].append(_share_moved(out[0], gn.gn_relu_bwd_plain(x, dy, sc, bi, groups,
                                                                       eps)[0]))
        return out

    # The wrappers count their launches on the module's names, now these.
    rec_fwd.launches = rec_bwd.launches = 0
    return _swapped(((gn, "gn_relu_forward", rec_fwd), (gn, "gn_relu_backward", rec_bwd)))


def gn_ulp_moved(shares, seed: int):
    """K4/K5's wrappers replaced by their plain versions whose outputs (y; dx)
    are moved by one ulp, up or down, on a random share of their non-zero
    elements: call i of each takes shares[...][i] (from gn_recorded)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    calls = {"fwd": 0, "bwd": 0}
    gens = {}

    def moved(t, key):
        share = shares[key][calls[key] % len(shares[key])]
        calls[key] += 1
        if t.device not in gens:
            gens[t.device] = torch.Generator(t.device).manual_seed(seed)
        g = gens[t.device]
        bits = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
        live = t != 0                    # as many elements as the kernel moved
        p = share * t.numel() / max(int(live.sum()), 1)
        pick = (torch.rand(t.shape, generator=g, device=t.device) < p) & live
        step = torch.where(torch.rand(t.shape, generator=g, device=t.device) < 0.5, -1, 1)
        return (bits + pick.to(bits.dtype) * step.to(bits.dtype)).view(t.dtype)

    def fwd(x, sc, bi, groups, eps):
        return moved(gn.gn_relu_plain(x, sc, bi, groups, eps), "fwd")

    def bwd(x, dy, sc, bi, groups, eps):
        dx, dg, db = gn.gn_relu_bwd_plain(x, dy, sc, bi, groups, eps)
        return moved(dx, "bwd"), dg, db

    return _swapped(((gn, "gn_relu_forward", fwd), (gn, "gn_relu_backward", bwd)))


@timed
def celeba_step_check(dev, out_root, bf16=False, arch="ACGAN", adaptive=False):
    """One full-width D step and one G step of the conditional arch `arch`
    (with ``adaptive``, a D step of ``-gcm adaptive`` that takes its
    threshold from a mean-sample batch through K2 first; bs 8; fp32 with
    TF32 off, or
    bf16 compute, where K2/K3 take their tensor-core variant; deterministic
    cuDNN), each from the initial state, on the card: through
    K2-K5 against the same steps through the plain versions, the D step on
    the kernel side's fakes on both sides (its fakes, the G forward through
    K4, are held on their own: STEP_BOUND_FAKES). Two witnesses
    beside the gap: the plain steps run twice (cuDNN repeats exactly, so K2-K5
    are the only difference), and the plain steps with z moved by 1e-7
    relative (how far a perturbation the size of K4's reduction-order gap
    moves the steps). Under bf16 the steps are held twice: K2/K3 alone (the
    reference swaps K2/K3 only, to the fixed bounds), and K2-K5 against the
    all-plain step, to STEP_BF16_FACTOR times the all-plain step's own
    witness with K4/K5's outputs moved by one ulp on the share of elements
    that K4/K5 moved in the kernel step (a z moved by 1e-7 rounds back to
    the same bf16 value)."""
    import numpy as np
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    bs = 8
    tag = ("celeba_step_bf16" if bf16 else "celeba_step") + ("" if arch == "ACGAN" else
                                                             f"_{arch}")
    tag += "_adaptive" if adaptive else ""
    argv = ["CelebA", "--conditional", "--conditional_arch", arch, "-dpm", "gc", "-bs",
            str(bs), "-tss", "12800", "-nms", "1", "--mean_sample_size", "8", "--sigma", "0",
            "-c", "1", "--train_d_until_threshold", "1e18", "--manual_seed", "1",
            "--platform", "gpu", "-o", str(out_root / tag)]
    argv += ["--bf16", "true"] if bf16 else []
    argv += ["-gcm", "adaptive"] if adaptive else []
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 2, bs)
    z, zg = (rng.standard_normal((bs, 128)).astype(np.float32) for _ in range(2))
    yg = rng.integers(0, 2, bs)
    pen_x = rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (bs, 1, 1, 1)).astype(np.float32)
    nudge = [1 + 1e-7 * rng.standard_normal(v.shape).astype(np.float32) for v in (z, zg)]
    ax = rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32)
    ay = rng.integers(0, 2, bs)
    opt = toptions.parse(argv)
    G, D = init_models(opt, dev)
    b = StepBuilder(opt, G, D)
    assert b.use_conv_ghost and b.adaptive == adaptive
    st0 = b.init_state()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    adapt = dict(ax=t(ax), ay=t(ay)) if adaptive else {}
    noise = [torch.zeros_like(st0.d_params[k]) for k in b.d_leaves]

    def steps(zd, zgen, fakes=None):
        """(D state, G state, D metrics, G metrics, the D step's fakes); the
        D step takes `fakes` instead of its own G forward when given."""
        used = []

        def own_or_given(g_params, zz, yy):
            used.append(StepBuilder.fakes(b, g_params, zz, yy) if fakes is None else fakes)
            return used[-1]
        b.fakes = own_or_given
        try:
            st_d, dm = b.d_step_gc(st0, t(x), t(y), t(zd), noise=noise, pen_x=t(pen_x),
                                   pen_y=t(y), alphas=[t(alpha)], **adapt)
        finally:
            del b.fakes
        # The G step starts from the initial D too: after a first Adam step
        # (b1 0) each D param has moved by lr times the sign of its gradient,
        # so a D gradient component within rounding of 0 would flip there.
        st_g, gm = b.g_step_dcresnet(st0, t(zgen), t(yg))
        torch.cuda.synchronize()
        return st_d, st_g, dm, gm, used[0]

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    tc_before = pcg.ghost_sq_norms.launches_tc + pcg.weighted_kernel_grad.launches_tc
    shares = {"fwd": [], "bwd": []}
    try:
        with gn_recorded(shares) if bf16 else contextlib.nullcontext():
            kern = steps(z, zg)
        took_tc = pcg.ghost_sq_norms.launches_tc + pcg.weighted_kernel_grad.launches_tc - tc_before
        with plain_versions(groupnorm=not bf16):
            plain = steps(z, zg, fakes=kern[4])
            again = steps(z, zg, fakes=kern[4])
            nudged = steps(z * nudge[0], zg * nudge[1])
            own = steps(z, zg)
        if bf16:
            with plain_versions():
                all_plain = steps(z, zg)
            with plain_versions(groupnorm=False), gn_ulp_moved(shares, seed=7):
                all_moved = steps(z, zg)
    finally:
        cudnn.deterministic, cudnn.benchmark = was

    # Each group as one vector: D params and moments after the D step, G
    # moments (the gradient and 0.1 x its square; b1 0, b2 0.9) after the G
    # step. G params are left out: the first Adam step moves each by +-lr,
    # and those of G's GroupNorm biases start at 0.
    def gaps(one, ref):
        (d1, g1, dm1, gm1, _), (d0, g0, dm0, gm0, _) = one, ref
        out = {}
        for group, u, v in (("D params", d1.d_params, d0.d_params), ("D mu", d1.d_mu, d0.d_mu),
                            ("D nu", d1.d_nu, d0.d_nu), ("G mu", g1.g_mu, g0.g_mu),
                            ("G nu", g1.g_nu, g0.g_nu)):
            out[group] = rel_l2(torch.cat([u[k].reshape(-1) for k in v]),
                                torch.cat([v[k].reshape(-1) for k in v]))
        # Accuracies and clipped shares count samples: left out.
        counts = ("d_real_acc", "d_fake_acc", "d_real_aux_acc", "frac_clipped", "g_aux_acc")
        out["metrics"] = max(
            float((m1[k] - m0[k]).abs().max() / max(float(m0[k].abs().max()), 1e-2))
            for m1, m0 in ((dm1, dm0), (gm1, gm0)) for k in m1 if k not in counts)
        return out

    fmt = lambda r: ", ".join(f"{k} {v:.3e}" for k, v in r.items())  # noqa: E731
    gap, rep, wit = gaps(kern, plain), gaps(again, plain), gaps(nudged, own)
    print(f"CelebA {arch}{' adaptive' if adaptive else ''} D step and G step (bs {bs}, "
          f"{'bf16' if bf16 else 'fp32'}, full width) "
          f"on the card, {'K2/K3' if bf16 else 'K2-K5'} vs plain: rel l2 {fmt(gap)} (bounds D "
          f"{STEP_BOUND_D:g}, G "
          f"{STEP_BOUND_G:g}, metrics {STEP_BOUND_MET:g}); clipped "
          f"{float(kern[2]['frac_clipped'].mean()):.2f}; K2 + K3 launches on the tensor cores "
          f"{took_tc}")
    if took_tc != ((3 if adaptive else 2) * len(CONV_LAYERS) if bf16 else 0):
        fail(f"K2/K3 took the tensor-core variant {took_tc} times in the "
             f"{'bf16' if bf16 else 'fp32'} step")
    fakes_gap, fakes_wit = rel_l2(kern[4], own[4]), rel_l2(nudged[4], own[4])
    print(f"  witnesses: plain repeated {fmt(rep)}; plain with z moved 1e-7 {fmt(wit)}")
    print(f"  the D step's fakes (the kernel side's G forward vs the reference's): rel l2 "
          f"{fakes_gap:.3e} (bound "
          f"{STEP_BOUND_FAKES:g}; z moved 1e-7: {fakes_wit:.3e}); the plain D step on its own "
          f"fakes, against the kernel D step: {fmt(gaps(kern, own))} (printed only)")
    if not fakes_gap < STEP_BOUND_FAKES:
        fail("the G forward through K4 leaves the plain G forward in the CelebA step check")
    if bf16:
        full, wit16 = gaps(kern, all_plain), gaps(all_moved, all_plain)
        held16 = [(k, full[k], STEP_BF16_FACTOR * wit16[k]) for k in full]
        mean = lambda v: sum(v) / len(v)  # noqa: E731
        print(f"  K4/K5 in the kernel step moved {mean(shares['fwd']):.3e} of y's elements and "
              f"{mean(shares['bwd']):.3e} of dx's against their plain versions (mean of "
              f"{len(shares['fwd'])} / {len(shares['bwd'])} calls; largest "
              f"{max(shares['fwd']):.3e} / {max(shares['bwd']):.3e})")
        print(f"  K2-K5 vs all plain (bf16): rel l2 {fmt(full)}; witness, all plain with K4/K5's "
              f"outputs moved one ulp on those shares: {fmt(wit16)}; held "
              + ", ".join(f"{kind} {gap:.3e} <= {b:.3e}" for kind, gap, b in held16)
              + f" ({STEP_BF16_FACTOR:g}x the witness)")
        if not all(gap <= b for _, gap, b in held16):
            fail(f"the bf16 CelebA {arch} steps through K2-K5 leave the all-plain steps by "
                 f"more than {STEP_BF16_FACTOR:g}x the one-ulp witness")
    d_gap = max(v for k, v in gap.items() if k.startswith("D"))
    g_gap = max(v for k, v in gap.items() if k.startswith("G"))
    if max(rep.values()) != 0.0:
        fail("the plain CelebA steps do not repeat exactly on the card")
    if not (d_gap < STEP_BOUND_D and g_gap < STEP_BOUND_G and gap["metrics"] < STEP_BOUND_MET):
        fail(f"the CelebA {arch} steps ({'bf16' if bf16 else 'fp32'}) through the kernels "
             f"disagree with the plain steps on the card")


# A profiled window of the step runner: the first PROFILE_STEPS D steps of
# one more epoch, its CUDA activity only (the CPU operators' events made the
# window's tables ~1 s a CelebA D step to build: 104.6 s for the CelebA
# flagship's epoch of 100, NVIDIA H100 80GB HBM3).
PROFILE_STEPS = 5


@timed
def profile_step_runner(tr, label: str, need=()) -> None:
    """Device time by CUDA kernel and by group over the first PROFILE_STEPS
    D steps of one more epoch of a Trainer on the step runner
    (torch.profiler / CUPTI). Fails if a group in `need` took no device
    time. Returns (device busy ms, the window's ms, [(ms, launches,
    kernel)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n_epoch = tr.runner.n
    n = tr.runner.n = min(n_epoch, PROFILE_STEPS)
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s0.record()
            tr.state, *_ = tr.runner.run(tr.state, tr.gen_perm, tr.gen, 1)
            s1.record()
            torch.cuda.synchronize()
    finally:
        tr.runner.n = n_epoch
    span = s0.elapsed_time(s1)
    by_kernel = device_ms_by_kernel(prof)
    busy = sum(r[0] for r in by_kernel)
    print(f"{label} profile: device busy {busy:.3f} ms of {span:.3f} ms over {n} D steps "
          f"({100 * busy / span:.1f}%), by kernel (ms, launches, name):")
    for t_ms, cnt, key in by_kernel[:25]:
        print(f"  {t_ms:9.3f} {cnt:6d}  {key}")
    groups = {}
    for t_ms, _, key in by_kernel:
        g = next((name for name, keys in PROFILE_GROUPS if any(k in key for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + t_ms
    print(f"{label} profile by group (ms per D step, share of device busy): " + "; ".join(
        f"{g} {t / n:.3f} ({100 * t / busy:.1f}%)"
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    for g in need:
        if not groups.get(g, 0.0) > 0.0:
            fail(f"the {label} profile shows no device time in the group {g}")
    return busy, span, by_kernel


def celeba_phases(dev, out_root, peak_bf16, peak_bytes):
    """The kernel checks, then the CelebA flagship through the Trainer.
    Returns the kernels-line entries of K2-K5 and the path's ms per D step."""
    import csv
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.training.loop import Trainer

    entries = conv_ghost_phase(dev, peak_bf16, peak_bytes)
    entries += groupnorm_phase(dev, peak_bytes)
    celeba_step_check(dev, out_root)
    celeba_step_check(dev, out_root, bf16=True)

    e = CELEBA_EPOCHS
    opt = toptions.parse(FLAGSHIP + ["-ne", str(e), "--log_every", str(12800 * e),
                                     "--manual_seed", "1", "-o", str(out_root / "celeba")])
    tr = Trainer(opt)
    wrappers = (pcg.ghost_sq_norms, pcg.weighted_kernel_grad, gn.gn_relu_forward,
                gn.gn_relu_backward)
    for w in wrappers:
        w.launches = 0
    pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]
    if not all(n > 0 for n in launches):
        fail(f"a CelebA-path kernel never launched: K2-K5 launches {launches}")
    n = tr.n_batches
    launches_tc = [pcg.ghost_sq_norms.launches_tc, pcg.weighted_kernel_grad.launches_tc]
    if launches[:2] != launches_tc or launches_tc != [len(CONV_LAYERS) * e * n] * 2:
        fail(f"K2/K3 launched {launches[:2]} times on the flagship, {launches_tc} of them "
             f"on the tensor cores; expected {len(CONV_LAYERS)} per D step, all tensor-core")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out_root / "celeba" / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out_root / "celeba" / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    losses = [float(row[k]) for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss",
                                      "D Real Loss", "D Fake Loss", "D Real Aux Loss",
                                      "D Penalty")]
    if len(eps) != e or not all(math.isfinite(x) and x > 0 for x in eps):
        fail(f"bad epsilon column {eps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite CelebA losses {losses}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail("non-finite params after CelebA training")
    if tr.state.d_count != e * n or tr.state.g_count != e * -(-n // opt.n_d_steps):
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} after {e} "
             f"epochs of {n} steps")
    with torch.no_grad():
        img = tr.builder.fakes(tr.state.g_params, tr.builder.gen_z(tr.gen, 4),
                               tr.builder.gen_y(tr.gen, 4))
    if tuple(img.shape) != (4, 64, 64, 3) or not bool((img.abs() <= 1).all()):
        fail(f"bad generator output {tuple(img.shape)}")
    rest = ep_ms[1:] or ep_ms
    step_ms = sum(rest) / len(rest) / n
    print(f"CelebA path: {e} epoch(s) x {n} D steps ({tr.state.g_count} G updates), K2-K5 "
          f"launches {launches} (K2 / K3 on the tensor cores {launches_tc}); ms per D step "
          f"{step_ms:.3f} ({'the first epoch, warm process' if e == 1 else 'after the first'}; "
          f"epochs {', '.join(f'{x:.1f}' for x in ep_ms)} ms); "
          f"{CB * 1e3 / step_ms:.0f} samples/s; wall {wall:.2f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; epsilon "
          f"{eps[-1]:.6f} (mean samples {tr.mean_sample_privacy_cost:.6f}); losses "
          + ", ".join(f"{x:.4f}" for x in losses))

    profile_step_runner(tr, "CelebA", need=("K4/K5 gn_relu",))
    for entry, count in zip(entries, launches):
        entry["launches"] = count
    return entries, step_ms


def _step_builder(argv, dev, out_dir):
    """(opt, StepBuilder) of a config on the card, as the Trainer builds them."""
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    opt = toptions.parse(argv + ["--manual_seed", "1", "--platform", "gpu", "-o", str(out_dir)])
    G, D = init_models(opt, dev)
    return opt, StepBuilder(opt, G, D)


@timed
def k6_held(g, dev, b, p, tag, peak_bytes, base=0, on_device=True):
    """K6 against its plain version at [b, p] (the sum at std 0 to
    K6_SUM_BOUND, sum and noise with one seed to K6_NOISE_BOUND * std), run
    twice (bitwise), with another seed (a new draw) and the noise's moments,
    timed beside its plain version and ``w @ g`` + ``randn``. With a counter
    ``base`` (a model slice's, --tp) both run at it, and K6's noise there is
    held to the same columns of K6's noise over the whole [b, base + p]
    leaf, bit for bit. ``on_device``: also timed on the device (the
    profiler's trace reads right early in a process; see main). Returns
    (times and bytes bound, max abs gap)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    std = torch.tensor(K6_STD, device=dev)
    zero = torch.tensor(0.0, device=dev)
    x = torch.randn(b, p, generator=g, device=dev)
    w = torch.rand(b, generator=g, device=dev) * 0.9 + 0.1
    seed = torch.randint(0, 2 ** 63 - 1, (), generator=g, device=dev)
    k0, p0 = pc.leaf_weighted_sum_noise(x, w, seed, zero, base), \
        pc.weighted_sum_noise_plain(x, w, seed, zero, base)
    k1, p1 = pc.leaf_weighted_sum_noise(x, w, seed, std, base), \
        pc.weighted_sum_noise_plain(x, w, seed, std, base)
    again = pc.leaf_weighted_sum_noise(x, w, seed, std, base)
    other = pc.leaf_weighted_sum_noise(x, w, seed + 1, std, base)
    if base:
        # w = 0: the output is std * z alone, on both sides exactly.
        w0 = torch.zeros_like(w)
        cut = pc.leaf_weighted_sum_noise(x, w0, seed, std, base)
        whole = pc.leaf_weighted_sum_noise(torch.zeros(b, base + p, device=dev), w0, seed, std)
        if not torch.equal(cut, whole[base:]):
            fail(f"K6 at counter base {base} is not the whole leaf's noise at [{b}, {p}]")
        print(f"K6 [{b}, {p}] at counter base {base}: its noise is columns {base}.."
              f"{base + p - 1} of the whole [{b}, {base + p}] leaf's, bit for bit")
        del whole
    torch.cuda.synchronize()
    r0 = rel_l2(k0, p0)
    gap = float((k1 - p1).abs().max())
    err = max(gap, float((k0 - p0).abs().max()))
    z = (k1 - k0) / K6_STD
    mean, sd = float(z.mean()), float(z.std())
    t = k6_times(lambda: pc.leaf_weighted_sum_noise(x, w, seed, std, base),
                 lambda: pc.weighted_sum_noise_plain(x, w, seed, std, base),
                 lambda: w @ x + std * torch.randn(p, device=dev),
                 4.0 * (b * p + b + p) + 12, peak_bytes, on_device)
    print(f"K6 [{b}, {p}] ({tag}): std 0 rel l2 {r0:.3e} (bound {K6_SUM_BOUND:g}); std "
          f"{K6_STD} same seed max abs gap {gap:.3e} (bound {K6_NOISE_BOUND * K6_STD:g}); "
          f"noise mean {mean:+.4f} std {sd:.4f}; " + k6_times_line(t))
    if not (r0 <= K6_SUM_BOUND and gap <= K6_NOISE_BOUND * K6_STD):
        fail(f"K6 disagrees with its plain version at [{b}, {p}]")
    if not torch.equal(k1, again):
        fail(f"K6 is not bitwise reproducible at [{b}, {p}]")
    if not float((k1 - other).abs().max()) > 0.1 * K6_STD:
        fail(f"K6's noise does not depend on the seed at [{b}, {p}]")
    if p >= 1 << 17 and not (abs(mean) < 0.05 and abs(sd - 1.0) < 0.02):
        fail(f"K6's noise moments are off at [{b}, {p}]: mean {mean}, std {sd}")
    return t, err


def device_ms_a_call(fn, reps: int) -> float:
    """Device ms of one call of fn from one torch.profiler window of reps
    calls: each CUDA kernel's mean time a launch times its launches a call
    (its count over reps, rounded), so an event the trace drops, or a
    stray kernel of another thread, moves neither."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(5):              # a trace now and then comes back empty
        total = sum(t / cnt * round(cnt / reps) for t, cnt, _ in traced_calls(fn, reps))
        if total > 0:
            return total
    fail("torch.profiler recorded no device time in 5 tries")


def k6_times(kernel, plain, library, nbytes, peak_bytes, on_device=True):
    """K6's call timed by CUDA events and (``on_device``) on the device
    (torch.profiler), beside its plain version and ``w @ g + std * randn``
    (the library call, by the same clocks) and its bytes bound."""
    t = {"ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
         "library_ms": cuda_ms(library, 20), "bytes": nbytes,
         "bound_ms": nbytes / peak_bytes * 1e3}
    if on_device:
        t["device_ms"] = device_ms_a_call(kernel, 20)
        t["library_device_ms"] = device_ms_a_call(library, 20)
    return t


def k6_times_line(t):
    dv = "device_ms" in t
    return (f"K6 {t['ms']:.4f} ms by CUDA events"
            + (f", {t['device_ms']:.4f} on the device" if dv else "")
            + f"; w @ g + randn {t['library_ms']:.4f}"
            + (f" / {t['library_device_ms']:.4f}" if dv else "")
            + f"; plain {t['plain_ms']:.4f}; bound {t['bound_ms']:.4f} "
            f"({100 * t['bound_ms'] / t['ms']:.1f}% of the memory rate by events"
            + (f", {100 * t['bound_ms'] / t['device_ms']:.1f}% on the device)" if dv else ")"))


@timed
def k6_group_held(g, dev, b, ps, tag, peak_bytes, bases=None):
    """One K6 launch over leaves [b, p] (``ps``) at counter ``bases``
    against its plain version leaf by leaf (the sums at std 0 to
    K6_SUM_BOUND, sums and noise to K6_NOISE_BOUND * std), run twice
    (bitwise); each leaf's noise (w = 0) bit for bit its whole leaf's one-leaf
    draw at the base; timed as ``k6_times``, the library call one
    ``w @ g + std * randn`` a leaf. Returns (times, max abs gap)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    n = len(ps)
    bases = [0] * n if bases is None else bases
    xs = [torch.randn(b, p, generator=g, device=dev) for p in ps]
    ws = [torch.rand(b, generator=g, device=dev) * 0.9 + 0.1 for _ in ps]
    seeds = torch.randint(0, 2 ** 63 - 1, (n,), generator=g, device=dev)
    std = torch.full((n,), K6_STD, device=dev)
    zero = torch.zeros(n, device=dev)

    def grouped(stds, w=ws):
        return pc.leaves_weighted_sum_noise(xs, w, seeds, stds, bases)
    k0, p0 = grouped(zero), pc.leaves_weighted_sum_noise_plain(xs, ws, seeds, zero, bases)
    k1, p1 = grouped(std), pc.leaves_weighted_sum_noise_plain(xs, ws, seeds, std, bases)
    again = grouped(std)
    w0 = [torch.zeros_like(w) for w in ws]
    noise = grouped(std, w=w0)
    for i, (p, base) in enumerate(zip(ps, bases)):
        whole = pc.leaf_weighted_sum_noise(torch.zeros(b, base + p, device=dev), w0[i],
                                           seeds[i], std[i])
        if not torch.equal(noise[i], whole[base:]):
            fail(f"K6 group {tag}: leaf {i}'s noise at base {base} is not its whole leaf's")
        del whole
    torch.cuda.synchronize()
    r0 = max(rel_l2(a, c) for a, c in zip(k0, p0))
    gap = max(float((a - c).abs().max()) for a, c in zip(k1, p1))
    err = max(gap, max(float((a - c).abs().max()) for a, c in zip(k0, p0)))
    if not (r0 <= K6_SUM_BOUND and gap <= K6_NOISE_BOUND * K6_STD):
        fail(f"K6 group {tag} disagrees with its plain version")
    if not all(torch.equal(a, c) for a, c in zip(k1, again)):
        fail(f"K6 group {tag} is not bitwise reproducible")
    nbytes = sum(4.0 * (b * p + b + p) + 12 for p in ps)
    t = k6_times(lambda: grouped(std), lambda: pc.leaves_weighted_sum_noise_plain(
        xs, ws, seeds, std, bases), lambda: [w @ x + s * torch.randn(x.shape[1], device=dev)
                                             for w, x, s in zip(ws, xs, std)],
        nbytes, peak_bytes)
    plan = pc.group_plan(b, tuple(ps), (True,) * n, pc._n_sm(torch.device(dev).index))
    print(f"K6 group {tag}: {n} leaves [{b}, {list(ps)}] at bases {bases} in one launch (tile "
          f"{plan.tile}, cluster {plan.cluster}, {plan.rows} rows a CTA, "
          f"{(plan.tile0[-1] + -(-ps[-1] // plan.tile)) * plan.cluster} CTAs): std 0 rel l2 "
          f"{r0:.3e} (bound {K6_SUM_BOUND:g}); std {K6_STD} max abs gap {gap:.3e} (bound "
          f"{K6_NOISE_BOUND * K6_STD:g}); bitwise on a rerun; each "
          f"leaf's noise its whole leaf's at its base; " + k6_times_line(t))
    return t, err


# The -pupd false step's four K6 leaves at --tp 2, a rank's slices:
# conv2-conv4's weights and linOutAux, at the last model rank's bases.
K6_PUPD_TP2 = (102400, 409600, 1638400, 8192)


def clip_kernel_phase(dev, peak_bytes, large_leaves):
    """K6 against its plain version and timed: one leaf at path 1's leaf, at
    every large leaf of celeba_d64 (B 128), at an odd P, at the gate's P, at
    batch 50 and at [128, 8192]; one launch over path 2's four leaves and
    over the four -pupd false slices at --tp 2 at their counter bases.
    Returns the kernels-line
    entry (without its launch counts)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    g = torch.Generator(dev).manual_seed(23)
    path2 = sorted({n for _, n in large_leaves})
    p1 = (F + NC) * H
    shapes = [(BS, p1, "path 1")] + [(CB, n, "path 2") for n in path2]
    shapes += [(CB, n, "extra") for n in (33300, pc.MIN_PALLAS_ELEMS, 8192) if n not in path2]
    shapes += [(B50, p1, f"B {B50}")]
    rows, err = {}, 0.0
    for b, p, tag in shapes:
        t, e = k6_held(g, dev, b, p, tag, peak_bytes)
        rows[(b, p)] = (tag, t)
        err = max(err, e)
    one = rows[(BS, p1)][1]
    two, e = k6_group_held(g, dev, CB, [n for _, n in large_leaves], "path 2 (one D step)",
                           peak_bytes)
    err = max(err, e)
    pupd, e = k6_group_held(g, dev, CB, list(K6_PUPD_TP2), "-pupd false at --tp 2 (rank 1)",
                            peak_bytes, bases=list(K6_PUPD_TP2))
    err = max(err, e)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    return {"name": "leaves_weighted_sum_noise", "route": "cuda",
            "source": "csl_gan_tpu_torch/ops/csrc/clip_noise.cu",
            "replaces": "csl_gan_tpu/ops/pallas_clip.py:61",
            "max_abs_err": err, "ms": one["ms"], "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"], "bound_by": "bytes", "library_ms": one["library_ms"],
            "device_ms": one["device_ms"], "library_device_ms": one["library_device_ms"],
            "per": f"launch at path 1's leaf [{BS}, {p1}] (one per D step)",
            "path2": dict({k: two[k] for k in keys},
                          per=f"D step: one launch over {len(large_leaves)} leaves at B {CB}"),
            "pupd_tp2": dict({k: pupd[k] for k in keys},
                             per=f"-pupd false D step at --tp 2: one launch, 4 slices"),
            "shapes": {f"{b}x{p}": {k: t[k] for k in keys} for (b, p), (_, t) in rows.items()}}


@timed
def ghost_vs_materialized(dev, out_root):
    """The MNIST ghost-clipped real sum (analytic norms, matrix products)
    against the materialized one (vmap(grad), norms, weighted sum), bs 600."""
    import torch
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.models.common import one_hot
    from csl_gan_tpu_torch.ops import ghost, grads as gops

    _, b = _step_builder(["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs",
                          str(BS), "-tss", "60000"], dev, out_root / "ghost_check")
    imgs, labels = synthetic_mnist(BS, seed=13)
    x, y = torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)
    st = b.init_state()
    worst = 0.0
    for clip in (st.clipping, 0.05):        # some rows clipped; nearly all
        got, st_g, _ = ghost.vanilla_real_ghost(st.d_params, x, one_hot(y, NC), y,
                                                b.aux_scalar, clip, False)
        f, args = b.real_ps_args(x, y, b.row_weights(y))
        want, st_m = gops.clipped_grad_sum(f, st.d_params, *args, max_norm=clip)
        torch.cuda.synchronize()
        gap = max(rel_l2(got[k], want[k]) for k in b.d_leaves)
        worst = max(worst, gap, rel_l2(st_g.norm_mean, st_m.norm_mean))
        print(f"MNIST real pass bs {BS}, C {clip:g}: ghost vs materialized clipped sum rel l2 "
              f"{gap:.3e} (bound {GHOST_BOUND:g}), clipped {float(st_m.frac_clipped.mean()):.2f}")
    if not worst < GHOST_BOUND:
        fail("the ghost and the materialized clipped sums disagree")


@timed
def clip_step_check(dev, out_root, name, argv, batch):
    """One full-width D step through K6 against the same step through K6's
    plain version: same state, inputs and seeds, both on the card. Under
    adaptive clipping both take their std from the same public batch."""
    import torch
    from csl_gan_tpu_torch.ops import grads as gops
    from csl_gan_tpu_torch.training.penalty import draw_shape

    opt, b = _step_builder(argv, dev, out_root / f"{name.replace(' ', '_')}_step")
    assert b.fused_route
    st0 = b.init_state()
    bs = opt.batch_size
    g = torch.Generator(dev).manual_seed(31)
    x, y = batch(g, bs)
    z = b.gen_z(g, bs)
    leaves = [st0.d_params[k] for k in b.d_leaves]
    stds = None if b.adaptive else torch.tensor(
        gops.noise_stds(len(leaves), b.sigma, st0.clipping, b.per_layer), device=dev)
    fused = gops.draw_fused_noise(g, leaves, stds)
    pen = {}
    if b.adaptive:
        pen = dict(zip(("ax", "ay"), batch(g, bs)))
    if b.penalty_types:
        # The per-sample penalty (-pupd false) is on the real batch, and its
        # samples and its logged value take the same draws (as the runner).
        pen_x = x if b.ps_pen else torch.rand(x.shape, generator=g, device=dev) * 2 - 1
        pen.update(pen_x=pen_x, pen_y=y, alphas=[
            torch.rand(draw_shape(t, pen_x.shape), generator=g, device=dev)
            for t in b.penalty_types])
        if b.ps_pen:
            pen["ps_draws"] = pen["alphas"]

    def step():
        out = b.d_step_gc(st0, x, y, z, fused=fused, **pen)
        torch.cuda.synchronize()
        return out

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        (sk, mk) = step()
        with plain_clip():
            (sp, mp) = step()
    finally:
        cudnn.deterministic, cudnn.benchmark = was
    cat = lambda d: torch.cat([d[k].reshape(-1) for k in b.d_leaves])  # noqa: E731
    gaps = {"D params": rel_l2(cat(sk.d_params), cat(sp.d_params)),
            "D mu": rel_l2(cat(sk.d_mu), cat(sp.d_mu)), "D nu": rel_l2(cat(sk.d_nu), cat(sp.d_nu))}
    met = max(float((mk[k] - mp[k]).abs().max() / max(float(mp[k].abs().max()), 1e-2))
              for k in mk if "acc" not in k and k != "frac_clipped")
    if b.adaptive:
        std = sk.clipping * b.sigma
        if not torch.equal(sk.clipping, sp.clipping):
            fail(f"the {name} adaptive steps took different thresholds")
        print(f"{name} adaptive D step: threshold {float(sk.clipping):.6f}, std "
              f"{float(std):.6f} on both sides (the initial {b.opt.clipping_param:g})")
    print(f"{name} D step (bs {bs}, full width, sigma {b.sigma:g}) on the card, K6 vs plain: "
          f"rel l2 " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f", metrics {met:.3e} (bound {K6_STEP_BOUND:g}); clipped "
          f"{float(mk['frac_clipped'].mean()):.2f}")
    if not (max(gaps.values()) < K6_STEP_BOUND and met < K6_STEP_BOUND):
        fail(f"the {name} D step through K6 disagrees with the plain step on the card")
    return b, st0, (x, y, z, fused, pen)


@timed
def clip_step_breakdown(name, b, st0, inputs):
    """Where one full-width D step's device time goes: vmap(grad), the norms
    and clip factors, the fused sum (K6 and the small leaves), the rest."""
    import torch
    from csl_gan_tpu_torch.ops import grads as gops

    x, y, z, fused, pen = inputs
    fake = b.fakes(st0.g_params, z, y)
    row_w = b.row_weights(y)
    f, args = (b.real_ps_args(x, y, row_w) if b.grad_clip_split
               else b.combined_ps_args(x, y, fake, row_w))
    g_ps = gops.per_sample_grads(f, st0.d_params, *args)
    norms = gops.leaf_norms(g_ps)
    factors = gops.clip_factors(norms, st0.clipping, b.per_layer)
    t = {"vmap(grad)": cuda_ms(lambda: gops.per_sample_grads(f, st0.d_params, *args), 5),
         "norms and factors": cuda_ms(lambda: gops.clip_factors(
             gops.leaf_norms(g_ps), st0.clipping, b.per_layer), 5),
         "K6 + small leaves": cuda_ms(lambda: gops.weighted_sum_fused_noise(
             g_ps, factors, fused), 5)}
    # The same sum and noise unfused (--pallas false): one product and one
    # torch.randn per leaf.
    gen = torch.Generator(x.device).manual_seed(32)
    leaves, stds = list(st0.d_params.values()), fused.stds.tolist()
    unfused = cuda_ms(lambda: [s + n for s, n in zip(
        gops.weighted_sum(g_ps, factors).values(), gops.noise_like(gen, leaves, stds))], 5)
    del g_ps
    step = cuda_ms(lambda: b.d_step_gc(st0, x, y, z, fused=fused, **pen), 5)
    t["the rest (fakes, fake pass, penalty, Adam, metrics)"] = step - sum(t.values())
    print(f"{name} D step breakdown (CUDA events around each part, ms): whole step {step:.3f}; "
          + "; ".join(f"{k} {v:.3f} ({100 * v / step:.1f}%)" for k, v in t.items())
          + f"; beside it, the unfused sum + noise of --pallas false: {unfused:.3f}")


def clip_path(name, argv, tss, out_root, leaves_per_step, need=()):
    """A materialized path through the Trainer for K6_EPOCHS epochs: K6 one
    launch a D step over ``leaves_per_step`` leaves. Returns (ms per D step
    after the first epoch, K6 launches)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import StepRunner

    e = K6_EPOCHS
    opt = toptions.parse(argv + ["-ne", str(e), "--log_every", str(tss * e), "--manual_seed",
                                 "1", "-o", str(out_root / name)])
    tr = Trainer(opt)
    if not (isinstance(tr.runner, StepRunner) and tr.builder.fused_route):
        fail(f"{name} does not take the step runner's fused route")
    pc.leaves_weighted_sum_noise.launches = pc.leaves_weighted_sum_noise.leaves = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, leaves = pc.leaves_weighted_sum_noise.launches, pc.leaves_weighted_sum_noise.leaves
    n = tr.n_batches
    if launches != e * n or leaves != e * n * leaves_per_step:
        fail(f"K6 launched {launches} times over {leaves} leaves on {name}, expected {e * n} "
             f"over {e * n * leaves_per_step}")
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out_root / name / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    with open(out_root / name / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    losses = {k: float(row[k]) for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss", "D Real Loss",
                                         "D Fake Loss", "D Real Aux Loss")}
    if len(eps) != e or not all(math.isfinite(v) and v > 0 for v in eps):
        fail(f"bad epsilon column {eps} on {name}")
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite losses on {name}: {losses}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail(f"non-finite params after {name}")
    if tr.state.d_count != e * n or tr.state.g_count != e * -(-n // opt.n_d_steps):
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} on {name}")
    rest = ep_ms[1:] or ep_ms
    step_ms = sum(rest) / len(rest) / n
    print(f"{name}: {e} epoch(s) x {n} D steps ({tr.state.g_count} G updates), K6 launches "
          f"{launches} (one a D step over {leaves_per_step} leaves: {leaves}); ms per D step "
          f"{step_ms:.3f} ({'the first epoch, warm process' if e == 1 else 'after the first'}; "
          f"epochs {', '.join(f'{v:.1f}' for v in ep_ms)} ms); {opt.batch_size * 1e3 / step_ms:.0f} "
          f"samples/s; wall {wall:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; epsilon {eps[-1]:.6f}; losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    profile_step_runner(tr, name, need)
    return step_ms, launches


def k6_large_leaves():
    """celeba_d64's leaves that the gate sends to K6, [(name, P)], printed
    beside the small-leaf branch's."""
    from csl_gan_tpu_torch.models.dcresnet import celeba_d64, d_leaves
    from csl_gan_tpu_torch.ops import pallas_clip as pc

    d = celeba_d64(n_classes=2)
    sizes = {k: v.numel() for k, v in d.state_dict().items()}
    large = [(k, sizes[k]) for k in d_leaves(d) if sizes[k] >= pc.MIN_PALLAS_ELEMS]
    print(f"celeba_d64: {sum(sizes.values())} params; leaves the gate (>= "
          f"{pc.MIN_PALLAS_ELEMS} elements) sends to K6: "
          + ", ".join(f"{k} {n}" for k, n in large) + "; small-leaf branch: "
          + ", ".join(f"{k} {sizes[k]}" for k in d_leaves(d) if sizes[k] < pc.MIN_PALLAS_ELEMS))
    return large


def clip_phases(dev, out_root, entry, large, k1_epoch_ms, celeba_step_ms):
    """The two materialized paths, K6's launches on them into its
    kernels-line ``entry`` (from ``clip_kernel_phase``; ``large``: the leaves
    path 2 gives K6). Returns the entry."""
    import torch
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist

    ghost_vs_materialized(dev, out_root)

    def mnist_batch(g, bs):
        imgs, labels = synthetic_mnist(bs, seed=14)
        return torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)

    def celeba_batch(g, bs):
        return (torch.rand(bs, 64, 64, 3, generator=g, device=dev) * 2 - 1,
                torch.randint(0, 2, (bs,), generator=g, device=dev))

    for name, argv, batch in (("path 1", PATH1, mnist_batch), ("path 2", PATH2, celeba_batch)):
        b, st0, inputs = clip_step_check(dev, out_root, name, argv, batch)
        clip_step_breakdown(name, b, st0, inputs)
        del b, st0, inputs
        torch.cuda.empty_cache()
    ms1, n1 = clip_path("path 1", PATH1, 60000, out_root, 1)
    print(f"path 1 against the K1 path of this run: {ms1 * 100:.3f} ms per 100-step epoch "
          f"against {k1_epoch_ms:.3f} ({ms1 * 100 / k1_epoch_ms:.2f}x)")
    ms2, n2 = clip_path("path 2", PATH2, 1280, out_root, len(large), need=("K4/K5 gn_relu",))
    print(f"path 2 against the conv-ghost path of this run: {ms2:.3f} ms per D step against "
          f"{celeba_step_ms:.3f} ({ms2 / celeba_step_ms:.2f}x)")
    entry["launches"] = n1
    entry["path2"]["launches"] = n2
    entry["path2"]["leaves"] = n2 * len(large)
    return entry


# The saves phase: the flagships with saves every epoch, the MNIST one with
# a grid each epoch, the CelebA one with a grid every 50 D steps (a sub-epoch
# cadence, as its default is at full data).
SAVES_MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
               "-tss", "60000", "--log_every", "60000", "--manual_seed", "1"]
SAVES_CELEBA = FLAGSHIP + ["--log_every", "12800", "--sample_every", "6400",
                           "--manual_seed", "1"]
# Where two uninterrupted CelebA runs are not bitwise equal, the resumed run
# is held to this multiple of their gap (the bf16 step check's factor).
RESUME_FACTOR = 3.0
K4_FWD_KERNELS = ("gn_fwd_cluster", "gn_chunk_stats", "gn_sample_stats", "gn_apply")


def _one_header(path) -> list:
    with open(path) as fh:
        rows = list(csv.reader(fh))
    if not rows or rows[0][:1] != ["Epoch"] or sum(r[:1] == ["Epoch"] for r in rows) != 1:
        fail(f"{path} does not hold exactly one header")
    return rows[1:]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def save_gap(a: Path, b: Path) -> float:
    """0 when saves/G-2 and D-2 of two runs are equal byte for byte; else the
    largest relative l2 gap over their float leaves. Fails when anything else
    differs: Adam counts, accountant, generator states."""
    import numpy as np
    from csl_gan_tpu_torch.utils import msgpack

    worst = 0.0
    for f in ("G-2", "D-2"):
        ra, rb = (a / "saves" / f).read_bytes(), (b / "saves" / f).read_bytes()
        if ra == rb:
            continue
        la, lb = list(_leaves(msgpack.unpackb(ra))), list(_leaves(msgpack.unpackb(rb)))
        if [k for k, _ in la] != [k for k, _ in lb]:
            fail(f"{a.name} and {b.name}: saves/{f} hold other leaves")
        for (key, x), (_, y) in zip(la, lb):
            if isinstance(x, np.ndarray) and x.dtype.kind == "f" and x.shape == np.shape(y):
                d = float(np.linalg.norm((x - y).astype(np.float64)))
                worst = max(worst, d / (float(np.linalg.norm(y.astype(np.float64))) + 1e-30))
            elif not (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y):
                fail(f"{a.name} and {b.name}: saves/{f} differ at {key}")
    return worst


def train_run(argv, launches=()):
    """A Trainer built from the CLI arguments and run; `launches` are kernel
    wrappers whose counts are set to 0 just before the run and read just
    after. Returns (trainer, seconds to build it, ms of its first epoch,
    counts)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.training.loop import Trainer

    t0 = time.perf_counter()
    tr = Trainer(toptions.parse(argv))
    t_init = time.perf_counter() - t0
    for w in launches:
        w.launches = 0
    tr.run()
    torch.cuda.synchronize()
    counts = [w.launches for w in launches]
    first = tr.runner.epoch_events[0] if tr.runner.epoch_events else None
    return tr, t_init, first[0].elapsed_time(first[1]) if first else math.nan, counts


@timed
def resume_pair(name, argv, dataset, root, launches, smi, runs_a=1):
    """Run A (2 epochs, saves every epoch) `runs_a` times and run B (1 epoch,
    then 1 more resumed from its saves/*-1); returns (the gap of B to A, the
    gap of A to itself, the first A trainer)."""
    tr_a = None
    dirs = []
    for i in range(runs_a):
        d = root / f"{name}_a{i}"
        tr, _, _, _ = train_run(argv + ["-ne", "2", "--save_every", "1", "-o", str(d)])
        tr_a = tr_a or tr
        dirs.append(d)
    b = root / f"{name}_b"
    train_run(argv + ["-ne", "1", "-o", str(b)])
    tr_b, t_init, first_ms, counts = train_run(
        [dataset, "-rp", str(b), "-re", "1", "-ne", "2", "-ka", "n_epochs"], launches)
    if tr_b.start_epoch != 1:
        fail(f"{name}: the resumed run started at epoch {tr_b.start_epoch}")
    if not all(c > 0 for c in counts):
        fail(f"{name}: a kernel of the path did not launch after the resume: {counts}")
    for f in ("privacy_log.csv", "log.csv"):
        ra, rb = _one_header(dirs[0] / f), _one_header(b / f)
        if f == "privacy_log.csv" and ra != rb:
            fail(f"{name}: privacy_log.csv of the resumed run {rb} differs from {ra}")
    self_gap = save_gap(dirs[0], dirs[1]) if runs_a > 1 else 0.0
    gap = save_gap(dirs[0], b)
    print(f"{name} resume [{smi}]: saves/G-2 and D-2 of 1 + 1 resumed epochs against 2 "
          f"epochs: {'bitwise equal' if gap == 0 else f'gap {gap:.3e}'}"
          + (f" (two uninterrupted runs: "
             f"{'bitwise equal' if self_gap == 0 else f'gap {self_gap:.3e}'})"
             if runs_a > 1 else "")
          + f"; kernel launches after the resume {counts}; resumed run: Trainer with its "
          f"loads {t_init:.2f} s, first epoch {first_ms:.3f} ms")
    return gap, self_gap, tr_a


@timed
def checkpoint_io(name, tr, root, smi) -> None:
    """ms of one save_pair of a trainer's state and of load_g + load_d back,
    and the files' sizes."""
    import torch
    from csl_gan_tpu_torch.training import checkpoint

    d = root / f"{name}_io"
    acc = tr.accountant.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_pair(str(d), 1, 0, tr.state, acc)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    st, _ = checkpoint.load_g(str(d / "saves" / "G-1"), tr.state)
    st, _, acc_back, _ = checkpoint.load_d(str(d / "saves" / "D-1"), st)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    for a, b in ((st.d_params, tr.state.d_params), (st.g_params, tr.state.g_params),
                 (st.d_nu, tr.state.d_nu), (st.g_mu, tr.state.g_mu)):
        if not all(torch.equal(a[k], v) for k, v in b.items()):
            fail(f"{name}: a save loaded back differs from the state saved")
    if acc_back != acc:
        fail(f"{name}: the accountant loaded back is {acc_back}")
    mb = {f: (d / "saves" / f"{f}-1").stat().st_size / 1e6 for f in ("G", "D")}
    print(f"{name} checkpoint [{smi}]: save_pair {save_ms:.1f} ms (G {mb['G']:.2f} MB, "
          f"D {mb['D']:.2f} MB), load_g + load_d {load_ms:.1f} ms")


@timed
def k4_launches(fn):
    """K4's CUDA launches in one call of fn (after a warm-up call): counted by
    gn_relu.cu where each is issued, and read in a profiler trace of the same
    call. A trace can drop events, never add any: it fails if it reads more
    than the count. Returns (counted, traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    fn()
    torch.cuda.synchronize()
    before = gn.cuda_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counted = gn.cuda_launches() - before
    traced = sum(cnt for _, cnt, key in device_ms_by_kernel(prof)
                 if any(k in key for k in K4_FWD_KERNELS))
    if traced > counted:
        fail(f"a profiler trace read {traced} K4 launches where {counted} were issued")
    return counted, traced


@timed
def sample_check(tr, smi) -> None:
    """sample_images through K4 at the CelebA grid (B 24) and at gensamples'
    batch (B 50): each K4 call against its plain version on the same inputs
    (the groupnorm phase's bound), K4's CUDA launches counted as
    ``k4_launches`` says, and the images against the plain G forward on the
    card, to STEP_BF16_FACTOR times a witness: the plain G forward with each K4
    output moved one ulp on the share of elements that K4 call moved."""
    import torch

    b = tr.builder
    g = torch.Generator(tr.device).manual_seed(50)
    for tag, z, y in (("grid", tr.fixed_z, tr.fixed_y),
                      ("gensamples batch", b.gen_z(g, 50), b.gen_y(g, 50))):
        held_samples(b, tr.state, z, y, tag, smi)


@timed
def held_samples(b, state, z, y, tag, smi, bf16=True):
    """sample_images of a CelebA 64 G through K4 held as ``sample_check``
    says; ``bf16``: the G computes in bf16 (its norms after the first take
    bf16 inputs). Returns (images, K4 calls)."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    n = z.shape[0]
    gn.gn_relu_forward.launches = 0
    k = b.sample_images(state, z, y)
    calls = gn.gn_relu_forward.launches
    shares = {"fwd": [], "bwd": [], "fwd_gap": []}
    with gn_recorded(shares):
        again = b.sample_images(state, z, y)
    with plain_versions():
        p = b.sample_images(state, z, y)
    with gn_ulp_moved(shares, seed=7):
        w = b.sample_images(state, z, y)
    gap, witness, per_call = rel_l2(k, p), rel_l2(w, p), max(shares["fwd_gap"])
    want = sum(m * (1 if gn.launch_plan(n, hw, c, 32, torch.bfloat16 if bf16 and i > 0
                                        else torch.float32, False)[0] == gn.ONE_PASS
                    else 3) for i, (hw, c, m) in enumerate(GN_SHAPES))
    counted, traced = k4_launches(lambda: b.sample_images(state, z, y))
    print(f"sample_images at B {n} ({tag}) [{smi}]: each K4 call against its plain "
          f"version at most {per_call:.3e} relative l2 (bound {GN_BOUND:g}; "
          f"{100 * sum(shares['fwd']) / len(shares['fwd']):.2f}% of y's elements "
          f"moved on average); the images against the plain G forward {gap:.3e} "
          f"(witness, K4's outputs moved one ulp on those shares: {witness:.3e}; "
          f"bound {STEP_BF16_FACTOR:g}x it); K4 calls {calls}, CUDA launches {counted} "
          f"(counted where issued; the plans' {want}; a profiler trace read {traced}); "
          f"images {tuple(k.shape)} in "
          f"[{float(k.min()):.3f}, {float(k.max()):.3f}]")
    if not (per_call < GN_BOUND and gap <= STEP_BF16_FACTOR * witness
            and torch.equal(k, again)):
        fail(f"sample_images at B {n} ({tag}) is not held through K4")
    if calls != 9 or counted != want:
        fail(f"sample_images at B {n} ({tag}): {calls} K4 calls, {counted} CUDA launches")
    if tuple(k.shape) != (n, 64, 64, 3) or not bool(torch.isfinite(k).all()):
        fail(f"bad sample_images output {tuple(k.shape)}")
    return k, calls


def grid_names(tr) -> list:
    """The sample grids of 2 epochs of a trainer's configuration."""
    o, n = tr.opt, tr.n_batches
    if o.sample_every_epochs > 0:
        return [f"{e + 1}-{n - 1}.png" for e in range(2) if (e + 1) % o.sample_every_epochs == 0]
    return sorted(f"{e + 1}-{i}.png" for e in range(2) for i in range(n)
                  if (i + 1) * o.batch_size % o.sample_every == 0)


def png_shape(path):
    from csl_gan_tpu_torch.utils.images import read_png

    if not Path(path).is_file():
        fail(f"{path} was not written")
    return read_png(str(path)).shape


@timed
def sigterm_check(root, smi) -> None:
    """SIGTERM to the port's CLI on the MNIST flagship: exit 0, the preempt
    message and a save; a resume of 1 epoch continues epsilon."""
    import os
    import signal

    from csl_gan_tpu_torch.privacy import RdpAccountant

    d = root / "sigterm"
    argv = [sys.executable, "-m", "csl_gan_tpu_torch.train"] + SAVES_MNIST + [
        "-ne", "100000", "-o", str(d)]
    if CLOCK is not None:
        CLOCK.driven.add(("CLI", config_key(argv[3:])))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(dying_with_us(argv), cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            if proc.poll() is not None:
                fail("the CLI exited before SIGTERM:\n" + proc.communicate()[0][-3000:])
            if d.joinpath("privacy_log.csv").exists() and \
                    len([r for r in _one_header(d / "privacy_log.csv") if len(r) == 2]) >= 1:
                break
            if time.perf_counter() - t0 > 300:
                fail("no privacy_log.csv row within 300 s of starting the CLI")
            time.sleep(0.2)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stop_s = time.perf_counter() - t_sig
    if proc.returncode != 0 or "Preempted after epoch" not in out:
        fail(f"SIGTERM: exit {proc.returncode}\n{out[-3000:]}")
    rows = _one_header(d / "privacy_log.csv")
    n = len(rows)
    if not (d / "saves" / f"G-{n}").is_file() or not (d / "saves" / f"D-{n}").is_file():
        fail(f"SIGTERM after {n} epochs left no saves/G-{n}, D-{n}")
    eps_before = float(rows[-1][1])
    tr, _, _, _ = train_run(["MNIST", "-rp", str(d), "-re", str(n), "-ne", str(n + 1),
                             "-ka", "n_epochs"])
    rows = _one_header(d / "privacy_log.csv")
    acc = RdpAccountant(tr.opt.batch_size, tr.opt.train_set_size, tr.opt.sigma)
    acc.step((n + 1) * tr.n_batches)
    eps = float(rows[-1][1])
    print(f"SIGTERM [{smi}]: the CLI stopped {stop_s:.2f} s after the signal with exit 0 "
          f"after {n} epochs; resumed for 1 epoch, epsilon {eps_before:.6f} -> {eps:.6f} "
          f"(an accountant of {(n + 1) * tr.n_batches} steps: "
          f"{acc.get_privacy_spent(1e-5)[0]:.6f})")
    if len(rows) != n + 1 or not eps > eps_before or eps != acc.get_privacy_spent(1e-5)[0]:
        fail("the resumed run's epsilon does not continue the preempted run's")


@timed
def tools_check(root, smi) -> None:
    """gensamples, temp_file, budget_analysis and mem_inf_attack on the
    phase's saves, each timed."""
    import torch
    from csl_gan_tpu_torch import budget_analysis, gensamples, mem_inf_attack, temp_file
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    celeba, mnist = root / "celeba_a0", root / "mnist_a0"
    mia = root / "mia"
    calls = (
        ("gensamples (CelebA, -n 60 -bs 50)", gensamples.main,
         [str(celeba), "-e", "2", "-n", "60", "-bs", "50"]),
        ("temp_file (MNIST)", temp_file.main, [str(mnist), "-e", "2"]),
        ("temp_file (CelebA)", temp_file.main, [str(celeba), "-e", "2"]),
        ("budget_analysis (CelebA)", budget_analysis.main, [str(celeba), "2"]),
        ("mem_inf_attack (MNIST, pixel FID)", mem_inf_attack.main,
         ["--model_dir", str(root), "--model_name", "mnist_a0", "--checkpoints", "2",
          "--asr_iters", "200", "--compute_fid", "--generate_samples",
          "--num_generated_samples", "500", "--tmp_dir", f"{mia}/tmp/", "--samples_dir",
          f"{mia}/samples/", "--values_dir", f"{mia}/values/", "--outputs_dir",
          f"{mia}/outputs/", "--save"]),
    )
    for tag, main_fn, argv in calls:
        gn.gn_relu_forward.launches = 0
        t0 = time.perf_counter()
        main_fn(argv)
        torch.cuda.synchronize()
        print(f"tool {tag} [{smi}]: {time.perf_counter() - t0:.2f} s, K4 calls "
              f"{gn.gn_relu_forward.launches}")
    files = sorted((celeba / "G-2-samples").iterdir())
    if len(files) != 60 or png_shape(files[0]) != (64, 64, 3):
        fail(f"gensamples wrote {len(files)} files")
    with open(mia / "outputs" / "mnist_a0.json") as fh:
        stats = json.load(fh)["2"]
    if not (0.0 <= stats["asr"] <= 1.0 and math.isfinite(stats["pixel_fid"])):
        fail(f"mem_inf_attack stats {stats}")


def saves_phase(out_root, smi) -> None:
    """Checkpoints, resume, sample grids, SIGTERM and the evaluation tools on
    the card (the port's Trainer and its tools, through K1-K5)."""
    import shutil

    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    t_phase = time.perf_counter()
    root = out_root / "saves"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    gap, _, tr_m = resume_pair("mnist", SAVES_MNIST + ["--sample_every", "60000"], "MNIST",
                               root, (pe.epoch_kernel,), smi)
    if gap != 0:
        fail(f"the resumed MNIST run is not bitwise equal to the uninterrupted one ({gap:.3e})")
    checkpoint_io("mnist", tr_m, root, smi)

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        gap, self_gap, tr_c = resume_pair(
            "celeba", SAVES_CELEBA, "CelebA", root,
            (pcg.ghost_sq_norms, pcg.weighted_kernel_grad, gn.gn_relu_forward,
             gn.gn_relu_backward), smi, runs_a=2)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    if self_gap == 0 and gap != 0:
        fail(f"the resumed CelebA run differs from two bitwise-equal runs ({gap:.3e})")
    if self_gap > 0 and not gap <= RESUME_FACTOR * self_gap:
        fail(f"the resumed CelebA run's gap {gap:.3e} exceeds {RESUME_FACTOR:g}x the "
             f"witness {self_gap:.3e}")
    checkpoint_io("celeba", tr_c, root, smi)

    # The grids: 100 grey 28x28 images 10 a row, 24 RGB 64x64 images 2 a row.
    for name, tr, shape in (("mnist", tr_m, (302, 302)), ("celeba", tr_c, (794, 134, 3))):
        names = sorted(f.name for f in (root / f"{name}_a0" / "samples").iterdir())
        if names != grid_names(tr) or any(
                png_shape(root / f"{name}_a0" / "samples" / f) != shape for f in names):
            fail(f"{name} sample grids {names}, expected {grid_names(tr)} of {shape}")
        print(f"{name} sample grids [{smi}]: {names}, each {shape}")
    means = sorted((root / "celeba_a0" / "mean_samples").iterdir())
    if [m.name for m in means] != ["0-1.png", "1-1.png"] or png_shape(means[0]) != (64, 64, 3):
        fail(f"mean_samples: {[m.name for m in means]}")
    sample_check(tr_c, smi)
    del tr_c, tr_m
    torch.cuda.empty_cache()
    sigterm_check(root, smi)
    tools_check(root, smi)
    print(f"saves phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")


# The D-step engines beside gc (phase 7): MNIST at the K1 path's width (100
# steps an epoch), CelebA at the flagship's with its data cut to -tss 1280
# (10 D steps, 2 G updates an epoch), as path 2 is. moving-avg-pl runs at
# sigma 0.01: its scaling vector is a moving average of the NOISED per-leaf
# norms, and at sigma 10 the noise feeds back (lin1.weight's entry grows
# ~3.2x a step and overflows fp32 near step 36), in the JAX package as in
# the port.
DP_MNIST = ["MNIST", "--conditional", "--sigma", "10", "-bs", str(BS), "-tss", "60000"]
DP_MNIST_MODES = (("is", ["-dpm", "is"]), ("is per-param", ["-dpm", "is", "-ispp", "true"]),
                  ("is moving-avg-pl", ["-dpm", "is", "-issm", "moving-avg-pl",
                                        "--sigma", "0.01"]),
                  ("tm", ["-dpm", "tm"]), ("sv", ["-dpm", "sv"]))
DP_CELEBA = ["CelebA", "--conditional", "-bs", str(CB), "-tss", "1280", "-nms", "1",
             "--mean_sample_size", "8", "--bf16", "true", "--train_d_until_threshold", "1e18"]
DP_CELEBA_MODES = (("is", ["-dpm", "is"]), ("tm", ["-dpm", "tm"]), ("no DP", []))
K5_BWD_KERNELS = tuple(k for k in GN_KERNELS if k not in K4_FWD_KERNELS)


def dp_mode_run(name, argv, tss, out_root, smi):
    """One Trainer epoch of a D-step engine, timed by CUDA events, then
    PROFILE_STEPS more steps under the profiler. Returns (ms per D step of
    the epoch, K4 and K5 launches in it, K4 and K5 CUDA launches in the
    profiled steps, the Trainer)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import StepRunner

    out = out_root / "dp_modes" / name.replace(" ", "_")
    opt = toptions.parse(argv + ["-ne", "1", "--log_every", str(tss), "--manual_seed", "1",
                                 "-o", str(out)])
    t_start = time.perf_counter()
    tr = Trainer(opt)
    t_init = time.perf_counter() - t_start
    if not isinstance(tr.runner, StepRunner):
        fail(f"{name} does not take the step runner")
    wrappers = (gn.gn_relu_forward, gn.gn_relu_backward)
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]
    n = tr.n_batches
    first_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events][0] / n
    with open(out / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    losses = {k: float(row[k]) for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss",
                                         "D Real Loss", "D Fake Loss", "D Real Aux Loss")}
    extra = ""
    if "IS Mean" in row:
        sens = {k: [float(v) for v in row[k].strip("[]").split()]
                for k in ("IS Mean", "IS Min", "IS Max")}
        if not all(math.isfinite(v) and v >= 0 for vs in sens.values() for v in vs) or \
                not max(sens["IS Max"]) > 0:
            fail(f"{name}: bad IS columns {sens}")
        extra += "; " + "; ".join(f"{k} {' '.join(f'{v:.4g}' for v in vs)}"
                                  for k, vs in sens.items())
    if opt.use_dp:
        with open(out / "privacy_log.csv") as fh:
            eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
        if len(eps) != 1 or not (math.isfinite(eps[0]) and eps[0] > 0):
            fail(f"{name}: bad epsilon column {eps}")
        extra += f"; epsilon {eps[0]:.6f} ({type(tr.accountant).__name__})"
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite losses on {name}: {losses}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params,
                                                  tr.state.g_batch_stats) for t in p.values()):
        fail(f"non-finite params after {name}")
    if tr.state.d_count != n or tr.state.g_count != -(-n // opt.n_d_steps):
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} on {name}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = first_ms
    t_prof = time.perf_counter()
    busy, span, by_kernel = profile_step_runner(tr, name)
    t_prof = time.perf_counter() - t_prof
    traced = [sum(cnt for _, cnt, key in by_kernel if any(k in key for k in ks))
              for ks in (K4_FWD_KERNELS, K5_BWD_KERNELS)]
    norm = "BatchNorm" if tr.builder.g_has_bn else ("GroupNorm" if opt.model != "Vanilla"
                                                    else "no norm")
    print(f"{name} [{smi}]: {n} D steps an epoch ({tr.state.g_count} G updates so far), "
          f"G {norm}; ms per D step {step_ms:.3f} (the first epoch, warm process; "
          f"{opt.batch_size * 1e3 / step_ms:.0f} samples/s); device busy {busy:.3f} ms of "
          f"{span:.3f} ms over {min(n, PROFILE_STEPS)} profiled D steps "
          f"({100 * busy / span:.1f}%); wall of the Trainer "
          f"epoch {wall:.2f} s (Trainer built in {t_init:.2f} s; profile and its tables "
          f"{t_prof:.2f} s; the run {time.perf_counter() - t_start:.2f} s); peak memory {peak:.2f} GiB; K4 / K5 launches {launches} "
          f"(CUDA launches traced {traced}); losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()) + extra)
    return step_ms, launches, traced, tr


@timed
def is_step_breakdown(tr, gc_step_ms):
    """Where one full-width CelebA is D step's device time goes (CUDA events
    around each part): the first-order pass with its graph, the second-order
    pass (under -ispp true one batched backward with a cotangent per D
    leaf), the penalty's gradient, the rest (fakes, noise, Adam, metrics)."""
    import torch
    from csl_gan_tpu_torch.ops import grads as gops

    b, st0 = tr.builder, tr.state
    gen = torch.Generator(tr.device).manual_seed(33)
    x = torch.rand(CB, 64, 64, 3, generator=gen, device=tr.device) * 2 - 1
    y = b.gen_y(gen, CB)
    z = b.gen_z(gen, CB)
    leaves = [st0.d_params[k] for k in b.d_leaves]
    eps = gops.unit_normals(gen, leaves)
    pen_x, pen_y = tr.mean_sampler.device_sample(tr._dev_mean, gen, y, CB)
    alphas = [torch.rand((CB, 1, 1, 1), generator=gen, device=tr.device)]
    fake, _ = b._step_fakes(st0, z, y)

    def first():
        p = {k: v.detach().requires_grad_(True) for k, v in st0.d_params.items()}
        x_in = x.detach().requires_grad_(True)
        with torch.enable_grad():
            total = b._full_batch_loss(p, x_in, y, fake)[0]
            g = torch.autograd.grad(total, [p[k] for k in b.d_leaves], create_graph=True)
        return x_in, g

    def second():
        x_in, g = first()
        with torch.enable_grad():
            return b.sensitivity(list(g), x_in, st0.scaling_vec)

    t_first = cuda_ms(first, 3)
    t = {"first-order pass (graph kept)": t_first,
         f"second-order pass ({len(leaves)} leaves, batched)": cuda_ms(second, 3) - t_first,
         "penalty gradient": cuda_ms(lambda: b._penalty_grads(st0.d_params, pen_x, pen_y, fake,
                                                              alphas), 3)}
    whole = cuda_ms(lambda: b.d_step_is(st0, x, y, z, eps, pen_x=pen_x, pen_y=pen_y,
                                        alphas=alphas), 3)
    t["the rest (fakes, noise, Adam, metrics)"] = whole - sum(t.values())
    print(f"CelebA is D step breakdown (bs {CB}, per-parameter, CUDA events, ms): whole step "
          f"{whole:.3f}; " + "; ".join(f"{k} {v:.3f} ({100 * v / whole:.1f}%)"
                                       for k, v in t.items())
          + (f"; the conv-ghost gc D step of this run: {gc_step_ms:.3f} ms "
             f"({whole / gc_step_ms:.2f}x)" if gc_step_ms else ""))


@timed
def tm_step_check(dev, out_root):
    """One full-width CelebA tm D step and G step (bs 8, bf16 compute,
    deterministic cuDNN) through K4/K5 against the same steps with K4/K5's
    plain versions swapped in, both on the card and on the same draws (the
    trimmed mean's noise set to 0, so that the per-sample gradients decide
    it). Held, as the bf16 gc step is, to STEP_BF16_FACTOR times a witness:
    the plain steps with K4/K5's outputs moved by one ulp on the share of
    elements K4/K5 moved in the kernel steps."""
    import numpy as np
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    bs = 8
    opt = toptions.parse(["CelebA", "--conditional", "-dpm", "tm", "-bs", str(bs), "-tss",
                          "12800", "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
                          "--train_d_until_threshold", "1e18", "--manual_seed", "1",
                          "--platform", "gpu", "-o", str(out_root / "tm_step")])
    G, D = init_models(opt, dev)
    b = StepBuilder(opt, G, D)
    st0 = b.init_state()
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    x = t(rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32))
    y, yg = t(rng.integers(0, 2, bs)), t(rng.integers(0, 2, bs))
    z, zg = (t(rng.standard_normal((bs, 128)).astype(np.float32)) for _ in range(2))
    pen_x = t(rng.uniform(-1, 1, (bs, 64, 64, 3)).astype(np.float32))
    alpha = t(rng.uniform(0, 1, (bs, 1, 1, 1)).astype(np.float32))
    noise = [torch.zeros_like(st0.d_params[k]) for k in b.d_leaves]

    def steps():
        st_d, dm = b.d_step_tmsv(st0, x, y, z, noise, pen_x=pen_x, pen_y=y, alphas=[alpha])
        st_g, gm = b.g_step_dcresnet(st0, zg, yg)
        torch.cuda.synchronize()
        return st_d, st_g, dm, gm

    def gaps(one, ref):
        (d1, g1, dm1, gm1), (d0, g0, dm0, gm0) = one, ref
        out = {}
        for group, u, v in (("D params", d1.d_params, d0.d_params), ("D mu", d1.d_mu, d0.d_mu),
                            ("D nu", d1.d_nu, d0.d_nu), ("G mu", g1.g_mu, g0.g_mu),
                            ("G nu", g1.g_nu, g0.g_nu)):
            out[group] = rel_l2(torch.cat([u[k].reshape(-1) for k in v]),
                                torch.cat([v[k].reshape(-1) for k in v]))
        counts = ("d_real_acc", "d_fake_acc", "d_real_aux_acc", "g_aux_acc")
        out["metrics"] = max(
            float((m1[k] - m0[k]).abs().max() / max(float(m0[k].abs().max()), 1e-2))
            for m1, m0 in ((dm1, dm0), (gm1, gm0)) for k in m1 if k not in counts)
        return out

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    shares = {"fwd": [], "bwd": []}
    try:
        with gn_recorded(shares):
            kern = steps()
        with plain_versions():
            plain, again = steps(), steps()
        with gn_ulp_moved(shares, seed=7):
            moved = steps()
    finally:
        cudnn.deterministic, cudnn.benchmark = was
    fmt = lambda r: ", ".join(f"{k} {v:.3e}" for k, v in r.items())  # noqa: E731
    gap, rep, wit = gaps(kern, plain), gaps(again, plain), gaps(moved, plain)
    held = [(k, gap[k], STEP_BF16_FACTOR * wit[k]) for k in gap]
    print(f"CelebA tm D step and G step (bs {bs}, bf16, full width) through K4/K5 vs plain "
          f"on the card: rel l2 {fmt(gap)}; plain repeated {fmt(rep)}; witness, plain with "
          f"K4/K5's outputs moved one ulp on the shares they moved (mean "
          f"{sum(shares['fwd']) / len(shares['fwd']):.3e} of y's, "
          f"{sum(shares['bwd']) / len(shares['bwd']):.3e} of dx's; {len(shares['fwd'])} / "
          f"{len(shares['bwd'])} calls): {fmt(wit)}; held "
          + ", ".join(f"{k} {g:.3e} <= {bd:.3e}" for k, g, bd in held)
          + f" ({STEP_BF16_FACTOR:g}x the witness)")
    if not shares["fwd"] or not shares["bwd"]:
        fail("K4 / K5 did not run in the tm step check")
    if max(rep.values()) != 0.0:
        fail("the plain tm steps do not repeat exactly on the card")
    if not all(g <= bd for _, g, bd in held):
        fail(f"the bf16 CelebA tm steps through K4/K5 leave the plain steps by more than "
             f"{STEP_BF16_FACTOR:g}x the one-ulp witness")


def dp_modes_phase(dev, out_root, smi, gc_step_ms=None):
    """The D-step engines beside gc through the Trainer: MNIST (is flat, per
    parameter and moving-avg-pl, tm, sv) and CelebA (is, tm, no DP), the
    bf16 tm step through K4/K5 against its plain version and the CelebA is
    step's breakdown. Returns K4's and K5's launches on the CelebA tm
    path."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    shutil.rmtree(out_root / "dp_modes", ignore_errors=True)
    for name, mode in DP_MNIST_MODES:
        _, launches, _, tr = dp_mode_run(f"MNIST {name}", DP_MNIST + mode, 60000, out_root, smi)
        if launches != [0, 0]:
            fail(f"K4/K5 launched on the MNIST {name} path: {launches}")
        del tr
    tm_step_check(dev, out_root)
    tm_launches = None
    for name, mode in DP_CELEBA_MODES:
        _, launches, traced, tr = dp_mode_run(f"CelebA {name}", DP_CELEBA + mode, 1280,
                                              out_root, smi)
        # The G has GroupNorm (K4/K5) exactly when per-sample gradients are
        # on; under -dpm is and without DP it is the BatchNorm G.
        if not ((max(launches) == 0 and max(traced) == 0) if tr.builder.g_has_bn
                else (min(launches) > 0 and min(traced) > 0)):
            fail(f"CelebA {name}: K4 / K5 launches {launches} (traced {traced}) with a "
                 f"{'BatchNorm' if tr.builder.g_has_bn else 'GroupNorm'} G")
        if name == "tm":
            tm_launches = launches
        if name == "is":
            is_step_breakdown(tr, gc_step_ms)
        del tr
        torch.cuda.empty_cache()
    print(f"D-step engines phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")
    return tm_launches


# Phase 8: the conditional variants. CelebA at the flagship's flags cut as
# path 2 is (-tss 1280: 10 D steps and 2 G updates an epoch); MNIST at the
# flagship's (bs 600, 100 steps an epoch), where these variants leave K1
# (its gate takes conditional ACGAN only) for the step runner.
COND_CELEBA = ["CelebA", "-dpm", "gc", "-bs", str(CB), "-tss", "1280", "-nms", "1",
               "--mean_sample_size", "8", "--bf16", "true", "--train_d_until_threshold", "1e18"]
COND_MNIST = ["MNIST", "-dpm", "gc", "--sigma", "10", "-bs", str(BS), "-tss", "60000"]
COND_ARCHS = (("CGAN", ["--conditional", "--conditional_arch", "CGAN"]),
              ("WCGAN", ["--conditional", "--conditional_arch", "WCGAN"]),
              ("unconditional", []),
              ("ACGAN embed", ["--conditional", "--g_label_emb_mode", "embed"]))
COND_EPOCHS = 1                # as CELEBA_EPOCHS
# The G's norm layers, each one K4 launch a forward and one K5 launch a
# backward (celeba_g64: two a residual block, one before the output conv).
G_NORMS = 9


def cond_arch_run(name, argv, out_root, smi, expect, sub="cond_archs"):
    """COND_EPOCHS Trainer epochs of one variant (phase 8; phase 10's runs,
    outputs under ``sub``) in one group, every kernel's
    launches counted by its wrapper and held to ``expect(D steps, G
    updates)``, then PROFILE_STEPS more steps under the profiler. Checks
    finite logs and parameters, the update counts and epsilon against the
    port's accountant recomputed for the same steps plus the mean samples'
    cost. Returns (launches by kernel, ms per D step of the last epoch, the
    Trainer)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.privacy import RdpAccountant
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import StepRunner

    e = COND_EPOCHS
    tss = int(argv[argv.index("-tss") + 1])
    out = out_root / sub / name.replace(" ", "_")
    opt = toptions.parse(argv + ["-ne", str(e), "--log_every", str(tss * e), "--manual_seed",
                                 "1", "-o", str(out)])
    t_start = time.perf_counter()
    tr = Trainer(opt)
    if not isinstance(tr.runner, StepRunner):
        fail(f"{name} does not take the step runner")
    wrappers = {"K1": pe.epoch_kernel, "K2": pcg.ghost_sq_norms, "K3": pcg.weighted_kernel_grad,
                "K4": gn.gn_relu_forward, "K5": gn.gn_relu_backward,
                "K6": pc.leaves_weighted_sum_noise}
    for w in wrappers.values():
        w.launches = 0
    pc.leaves_weighted_sum_noise.leaves = 0
    pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["K6 leaves"] = pc.leaves_weighted_sum_noise.leaves
    launches["K2 tc"], launches["K3 tc"] = (pcg.ghost_sq_norms.launches_tc,
                                            pcg.weighted_kernel_grad.launches_tc)
    n = tr.n_batches
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    with open(out / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    logged = {k: [float(v) for v in row[k].strip("[]").split()] for k in row
              if k not in ("Epoch", "Batch")}
    if not all(math.isfinite(v) for vs in logged.values() for v in vs):
        fail(f"{name}: non-finite log values {logged}")
    if ("D Real Aux Loss" in row) != bool(opt.use_aux_loss):
        fail(f"{name}: the log's aux columns do not follow use_aux_loss")
    with open(out / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    acc = RdpAccountant(opt.batch_size, tss, opt.sigma)
    acc.step(e * n)
    want_eps = acc.get_privacy_spent(opt.delta)[0] + tr.mean_sample_privacy_cost
    if len(eps) != e or not math.isclose(eps[-1], want_eps, rel_tol=1e-12):
        fail(f"{name}: epsilon {eps}, expected {want_eps} after {e * n} steps")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail(f"non-finite params after {name}")
    g_updates = e * -(-n // opt.n_d_steps)
    if tr.state.d_count != e * n or tr.state.g_count != g_updates:
        fail(f"D / G update counts {tr.state.d_count} / {tr.state.g_count} on {name}")
    want = expect(e * n, g_updates)
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = ep_ms[-1] / n
    prof_n = min(n, PROFILE_STEPS)
    busy, span, _ = profile_step_runner(tr, name)
    print(f"{name} [{smi}]: {e} epochs x {n} D steps ({g_updates} G updates), "
          f"launches {launches}; ms per D step by epoch "
          f"{', '.join(f'{v / n:.3f}' for v in ep_ms)} (warm process; "
          f"{opt.batch_size * 1e3 / step_ms:.0f} samples/s in the last); device busy "
          f"{busy:.3f} ms of {span:.3f} ms over {prof_n} profiled D steps "
          f"({100 * busy / span:.1f}%); wall of the Trainer epochs {wall:.2f} s "
          f"(the run {time.perf_counter() - t_start:.2f} s); peak memory {peak:.2f} GiB; "
          f"epsilon {eps[-1]:.6f}; logged "
          + ", ".join(f"{k} {vs[0]:.4f}" for k, vs in logged.items() if len(vs) == 1))
    return launches, step_ms, tr


def cond_archs_phase(dev, out_root, smi, k1_step_ms=None, celeba_step_ms=None):
    """The CGAN, WCGAN, unconditional and embedded-G variants through the
    Trainer at full width: CelebA on the conv-ghost path (K2/K3 three times a
    D step on the tensor cores, K4 nine times a G forward, K5 nine times a G
    update, conv1 in the direct order), MNIST on the step runner (K1 never),
    then one bf16 D + G step of CGAN and of WCGAN through K2-K5 against the
    all-plain step, to STEP_BF16_FACTOR times the one-ulp witness. Returns
    {path: launches by kernel}."""
    import shutil

    import torch
    from csl_gan_tpu_torch.ops import conv_ghost

    def celeba_launches(n_d, n_g):
        """K2/K3 three times a D step on the tensor cores, K4 nine times a G
        forward (a D step's fakes, a G update), K5 nine times a G update."""
        return {"K1": 0, "K2": 3 * n_d, "K3": 3 * n_d, "K4": G_NORMS * (n_d + n_g),
                "K5": G_NORMS * n_g, "K6": 0, "K6 leaves": 0, "K2 tc": 3 * n_d,
                "K3 tc": 3 * n_d}

    launches_keys = celeba_launches(0, 0)
    t_phase = time.perf_counter()
    shutil.rmtree(out_root / "cond_archs", ignore_errors=True)
    by_path = {}
    for arch, variant in COND_ARCHS:
        name = f"CelebA {arch}"
        launches, step_ms, tr = cond_arch_run(name, COND_CELEBA + variant, out_root, smi,
                                              celeba_launches)
        conv1 = tr.D.TorchConv_0.weight.shape
        s, k, o = (tr.opt.im_size // 2) ** 2, conv1[1] * conv1[2] * conv1[3], conv1[0]
        ghost = conv_ghost._ghost_order(s, k, o)
        print(f"{name}: conv1 Cin {conv1[1]} (S {s}, K {k}, O {o}) takes the "
              f"{'ghost' if ghost else 'direct'} order; ms per D step {step_ms:.3f}"
              + (f", {step_ms / celeba_step_ms:.2f}x the ACGAN flagship's {celeba_step_ms:.3f} "
                 "of this run" if celeba_step_ms else ""))
        if ghost:
            fail(f"{name}: conv1 took the ghost order")
        by_path[name] = launches
        del tr
        torch.cuda.empty_cache()
    for arch, variant in COND_ARCHS[:3]:
        name = f"MNIST {arch}"
        launches, step_ms, tr = cond_arch_run(name, COND_MNIST + variant, out_root, smi,
                                              lambda n_d, n_g: dict.fromkeys(launches_keys, 0))
        print(f"{name}: ms per D step {step_ms:.3f} on the step runner"
              + (f", {step_ms / k1_step_ms:.2f}x the K1 path's {k1_step_ms:.3f} of this run"
                 if k1_step_ms else " (the K1 path not timed in this run)"))
        by_path[name] = launches
        del tr
    for arch in ("WCGAN", "CGAN"):
        celeba_step_check(dev, out_root, bf16=True, arch=arch)
    print(f"conditional variants phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# Phase 9: public data, warmup and adaptive clipping. Each run trains
# PUBLIC_EPOCHS epochs through the Trainer after its warmup: the MNIST
# flagship with mean samples and a warmup (the warmup on the step runner,
# then K1); the CelebA flagship's flags cut as path 2 is (-tss 1280) with a
# public split of 1280 rows and adaptive clipping, and with per-layer
# adaptive clipping on mean samples; path 1 with adaptive clipping, cut to
# -tss 6000 (10 D steps an epoch); and a batch of 50, which K1 does not take.
PUBLIC_EPOCHS = 1              # as CELEBA_EPOCHS
PUBLIC_MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
                "-tss", "60000"]
PUBLIC_CELEBA = ["CelebA", "--conditional", "-dpm", "gc", "-bs", str(CB), "-tss", "1280",
                 "--bf16", "true", "--train_d_until_threshold", "1e18"]
B50 = 50
PUBLIC_RUNS = (
    ("MNIST warmup", PUBLIC_MNIST + ["-nms", "2", "--mean_sample_size", "10", "-wi", "2"]),
    ("CelebA public adaptive", PUBLIC_CELEBA + ["-pss", "1280", "-gcm", "adaptive", "-wi", "2"]),
    ("CelebA mean-sample adaptive-pl", PUBLIC_CELEBA + ["-gcm", "adaptive-pl", "-nms", "1",
                                                        "--mean_sample_size", "8", "-wi", "2"]),
    ("path 1 adaptive", PATH1[:PATH1.index("-tss")] + ["-tss", "6000"]
     + PATH1[PATH1.index("-tss") + 2:] + ["-gcm", "adaptive", "-nms", "1",
                                           "--mean_sample_size", "10"]),
    ("CelebA B 50", FLAGSHIP[:FLAGSHIP.index("-bs")] + ["-bs", str(B50), "-tss", "500"]
     + FLAGSHIP[FLAGSHIP.index("-tss") + 2:]),
    ("MNIST B 50", ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(B50),
                    "-tss", "5000"]),
)


def public_expect(name, n_dp, n_warm, g_train, g_warm):
    """The launches of each kernel on a phase-9 run: (D steps with DP, warmup
    D steps, G updates after the warmup, warmup G updates) -> {kernel: n}."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K6 leaves", "K2 tc", "K3 tc"), 0)
    if name.startswith("MNIST warmup"):
        out["K1"] = PUBLIC_EPOCHS
    elif name.startswith("CelebA"):
        # Adaptive runs add one norms-only K2 pass a DP step; every D step
        # (the warmup's too) makes its fakes through K4, every G update
        # runs K4 and K5.
        k2 = (6 if "adaptive" in name else 3) * n_dp
        out.update({"K2": k2, "K3": 3 * n_dp, "K2 tc": k2, "K3 tc": 3 * n_dp,
                    "K4": G_NORMS * (n_dp + n_warm + g_train + g_warm),
                    "K5": G_NORMS * (g_train + g_warm)})
    elif name.startswith("path 1"):
        out["K6"] = out["K6 leaves"] = n_dp
    return out


def public_run(name, argv, out_root, smi, ref_ms):
    """PUBLIC_EPOCHS Trainer epochs of one phase-9 run in one group after its
    warmup, every kernel's launches counted by its wrapper and held to
    ``public_expect``; the step runner's D steps counted (the warmup's
    only, on the K1 path). Checks finite logs and parameters, the update
    counts (the warmup's Adam counts reset), the D save's Adam count,
    epsilon (the accountant for the DP steps, plus the mean samples' cost)
    and, under adaptive clipping, the saved thresholds (finite, positive,
    not the initial ones). Prints ms per D step beside ``ref_ms``, the
    device-busy share of one more epoch (torch.profiler; on the step runner
    cut to PROFILE_STEPS D steps), peak memory and
    the card. Returns (launches by kernel, ms per D step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.privacy import make_accountant
    from csl_gan_tpu_torch.training import checkpoint
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner

    e = PUBLIC_EPOCHS
    tss = int(argv[argv.index("-tss") + 1])
    out = out_root / "public" / name.replace(" ", "_")
    opt = toptions.parse(argv + ["-ne", str(e), "--log_every", str(tss * e), "--manual_seed",
                                 "1", "-o", str(out)])
    t_start = time.perf_counter()
    tr = Trainer(opt)
    on_k1 = isinstance(tr.runner, EpochsRunner)
    if on_k1 != name.startswith("MNIST warmup"):
        fail(f"{name}: K1's runner taken {on_k1}")
    wrappers = {"K1": pe.epoch_kernel, "K2": pcg.ghost_sq_norms, "K3": pcg.weighted_kernel_grad,
                "K4": gn.gn_relu_forward, "K5": gn.gn_relu_backward,
                "K6": pc.leaves_weighted_sum_noise}
    for w in wrappers.values():
        w.launches = 0
    pc.leaves_weighted_sum_noise.leaves = 0
    pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
    step_runner_steps = [0]
    train_batch = tr.step_runner._train_batch

    def counted(*a, **k):
        step_runner_steps[0] += 1
        return train_batch(*a, **k)
    tr.step_runner._train_batch = counted
    init_clip = tr.state.clipping
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del tr.step_runner._train_batch
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["K6 leaves"] = pc.leaves_weighted_sum_noise.leaves
    launches["K2 tc"], launches["K3 tc"] = (pcg.ghost_sq_norms.launches_tc,
                                            pcg.weighted_kernel_grad.launches_tc)
    n, wi = tr.n_batches, int(opt.warmup_iter)
    n_d = 1 if on_k1 else max(1, opt.n_d_steps)
    g_train, g_warm = e * -(-n // n_d), -(-wi // n_d)
    want = public_expect(name, e * n, wi, g_train, g_warm)
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    if step_runner_steps[0] != wi + (0 if on_k1 else e * n):
        fail(f"{name}: the step runner ran {step_runner_steps[0]} D steps")
    with open(out / "log.csv") as fh:
        row = list(csv.DictReader(fh))[-1]
    logged = {k: [float(v) for v in row[k].strip("[]").split()] for k in row
              if k not in ("Epoch", "Batch")}
    if not all(math.isfinite(v) for vs in logged.values() for v in vs):
        fail(f"{name}: non-finite log values {logged}")
    with open(out / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    acc = make_accountant(opt)
    acc.step(e * n)
    want_eps = acc.get_privacy_spent(opt.delta)[0] + tr.mean_sample_privacy_cost
    if len(eps) != e or not math.isclose(eps[-1], want_eps, rel_tol=1e-12):
        fail(f"{name}: epsilon {eps}, expected {want_eps} after {e * n} DP steps")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail(f"non-finite params after {name}")
    if tr.state.d_count != e * n or tr.state.g_count != g_train:
        fail(f"{name}: D / G Adam counts {tr.state.d_count} / {tr.state.g_count}, expected "
             f"{e * n} / {g_train} (reset after the warmup)")
    saved, _, _, _ = checkpoint.load_d(str(out / "saves" / f"D-{e}"), tr.state)
    if saved.d_count != e * n:
        fail(f"{name}: the D save's Adam count is {saved.d_count}, expected {e * n}")
    clip_note = ""
    if tr.builder.adaptive:
        c, c0 = saved.clipping, init_clip
        if not (bool(torch.isfinite(c).all()) and bool((c > 0).all())
                and not torch.equal(c, c0)):
            fail(f"{name}: saved thresholds {c.tolist()} (initial {c0.tolist()})")
        clip_note = (f"; saved thresholds {[round(v, 4) for v in c.reshape(-1).tolist()]} "
                     f"(initial {[round(v, 4) for v in c0.reshape(-1).tolist()]})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ep_ms = [a.elapsed_time(b) for a, b in tr.runner.epoch_events]
    step_ms = ep_ms[-1] / n
    # The step runner's profiled epoch is cut to PROFILE_STEPS D steps.
    prof_n = tr.runner.n = tr.runner.n if on_k1 else min(n, PROFILE_STEPS)
    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with clocked(f"profile {name}"), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0.record()
        tr._run_group(e, 1)
        s1.record()
        torch.cuda.synchronize()
    tr.runner.n = n
    span = s0.elapsed_time(s1)
    rows = device_ms_by_kernel(prof)
    busy = sum(r[0] for r in rows)
    ref = (f", {step_ms / ref_ms:.2f}x the flagship's {ref_ms:.3f} of this run"
           if ref_ms else "")
    print(f"{name} [{smi}]: {wi} warmup + {e} x {n} D steps ({g_warm} + {g_train} G updates), "
          f"launches {launches}; step runner D steps {step_runner_steps[0]}; ms per D step "
          f"by epoch {', '.join(f'{v / n:.3f}' for v in ep_ms)}{ref} (warm process) "
          f"({opt.batch_size * 1e3 / step_ms:.0f} samples/s); device busy {busy:.3f} ms of "
          f"{span:.3f} ms over {prof_n} more D steps ({100 * busy / span:.1f}%); wall of the "
          f"Trainer "
          f"{wall:.2f} s (the run {time.perf_counter() - t_start:.2f} s); peak memory "
          f"{peak:.2f} GiB; epsilon {eps[-1]:.6f}{clip_note}; by kernel (ms, launches): "
          + "; ".join(f"{key[:48]} {t:.3f} {cnt}" for t, cnt, key in rows[:6]))
    return launches, step_ms


@timed
def b50_kernel_checks(dev, peak_bf16, peak_bytes, smi):
    """K2/K3 at conv2-conv4 (bf16, tensor cores), K4/K5 at the G's five norm
    shapes (bf16) and K6 at path 1's leaf, all at batch 50, against their
    plain versions to the bounds of steps 4 and 6; each timed beside its
    plain version. Returns {kernel: (ms, plain ms)} per D step / G pass /
    launch."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    g = torch.Generator(dev).manual_seed(24)
    t = {k: [0.0, 0.0] for k in ("K2", "K3", "K4", "K5")}
    for h, cin, cout in CONV_LAYERS:
        a, c, w, ks = conv_operands(g, dev, B50, h, cin, cout, torch.bfloat16)
        r2, r3, _, _ = conv_held(f"conv {h}x{h}x{cin}->{cout} B {B50}", a, c, w, ks, "tc")
        for key, fk, fp in (("K2", lambda: pcg.ghost_sq_norms(a, c, 5, 5, 2, 2),
                             lambda: pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2)),
                            ("K3", lambda: pcg.weighted_kernel_grad(a, c, w, ks, 2, 2),
                             lambda: pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2))):
            t[key][0] += cuda_ms(fk, 10)
            t[key][1] += cuda_ms(fp, 5)
        print(f"conv {h}x{h}x{cin}->{cout} bf16 (B {B50}), tensor cores: K2 rel l2 {r2:.3e}, "
              f"K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")
    for hw, c, mult in GN_SHAPES:
        x, dy, sc, bi = gn_operands(g, dev, B50, hw, c, torch.bfloat16)
        gn_held(x, dy, sc, bi)
        t["K4"][0] += mult * cuda_ms(lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5), 20)
        t["K4"][1] += mult * cuda_ms(lambda: gn.gn_relu_plain(x, sc, bi, 32, 1e-5), 5)
        t["K5"][0] += mult * cuda_ms(lambda: gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5), 20)
        t["K5"][1] += mult * cuda_ms(lambda: gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5), 5)
    k6, _ = k6_held(g, dev, B50, (F + NC) * H, f"B {B50}", peak_bytes, on_device=False)
    t["K6"] = [k6["ms"], k6["plain_ms"]]
    print(f"kernels at B {B50} [{smi}], ms by CUDA events (kernel, plain): K2 per D step "
          f"{t['K2'][0]:.4f}, {t['K2'][1]:.3f}; K3 per D step {t['K3'][0]:.4f}, {t['K3'][1]:.3f}; "
          f"K4 per G forward {t['K4'][0]:.4f}, {t['K4'][1]:.3f}; K5 per G backward "
          f"{t['K5'][0]:.4f}, {t['K5'][1]:.3f}; K6 at [{B50}, {(F + NC) * H}] {t['K6'][0]:.4f}, "
          f"{t['K6'][1]:.4f}")
    return t


def public_data_phase(dev, out_root, smi, peak_bf16, peak_bytes, k1_step_ms=None,
                      celeba_step_ms=None):
    """The phase-9 runs through the Trainer, then one bf16 CelebA adaptive
    D + G step (bs 8) through K2-K5 against the all-plain step (3x the
    one-ulp witness), one adaptive path-1 D step through K6 against K6's
    plain version (same seeds, same adapted std), and K2-K6 at batch 50
    against their plain versions. Returns ({run: launches by kernel}, the
    B 50 times)."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    shutil.rmtree(out_root / "public", ignore_errors=True)
    by_run = {}
    for name, argv in PUBLIC_RUNS:
        ref = celeba_step_ms if name.startswith("CelebA") else k1_step_ms
        by_run[name], _ = public_run(name, argv, out_root, smi, ref)
        torch.cuda.empty_cache()
    celeba_step_check(dev, out_root / "public", bf16=True, adaptive=True)

    def batch(g, bs):
        return (torch.rand(bs, 28, 28, 1, generator=g, device=dev),
                torch.randint(0, NC, (bs,), generator=g, device=dev))
    clip_step_check(dev, out_root / "public", "path 1 adaptive", PUBLIC_RUNS[3][1], batch)
    torch.cuda.empty_cache()
    b50 = b50_kernel_checks(dev, peak_bf16, peak_bytes, smi)
    print(f"public data, warmup and adaptive clipping phase [{smi}]: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return by_run, b50


# Phase 10, the rest of the DP training surface: each run COND_EPOCHS
# epochs through the Trainer. CelebA cut as path 2 is (-tss 1280, 10 D steps an epoch); the
# MNIST Poisson run at the flagship's size (100 D steps an epoch, 796-row
# buffers); the other MNIST runs cut to -tss 6000 (10 D steps an epoch).
SURFACE_MNIST = PUBLIC_MNIST[:PUBLIC_MNIST.index("-tss")] + ["-tss", "6000"]
CAP = CB + math.ceil(8 * math.sqrt(CB))     # the Poisson buffer of batch 128: 219 rows


def _conv_launches(n_d, n_g):
    """K2 and K3 three times a D step (tensor cores), K4 on each D step's
    fakes and G update, K5 on each G update."""
    return {"K2": 3 * n_d, "K3": 3 * n_d, "K2 tc": 3 * n_d, "K3 tc": 3 * n_d,
            "K4": G_NORMS * (n_d + n_g), "K5": G_NORMS * n_g}


def _surface_expect(counts):
    """``counts(D steps, G updates)`` over zero launches of every kernel."""
    def expect(n_d, n_g):
        out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K6 leaves", "K2 tc",
                             "K3 tc"), 0)
        out.update(counts(n_d, n_g))
        return out
    return expect


SURFACE_RUNS = (
    ("CelebA Poisson", PUBLIC_CELEBA + ["-nms", "1", "--mean_sample_size", "8", "--poisson",
                                        "true"], _conv_launches),
    ("MNIST Poisson", PUBLIC_MNIST + ["--poisson", "true"], lambda n_d, n_g: {}),
    ("CelebA per-sample penalty", PUBLIC_CELEBA + ["-pupd", "false", "--pallas", "true"],
     lambda n_d, n_g: {"K6": n_d, "K6 leaves": 4 * n_d, "K4": G_NORMS * (n_d + n_g),
                       "K5": G_NORMS * n_g}),
    ("MNIST per-sample DRAGAN", SURFACE_MNIST + ["--penalty", "DRAGAN1", "-pupd", "false",
                                                 "--pallas", "true"],
     lambda n_d, n_g: {"K6": n_d, "K6 leaves": n_d}),
    ("CelebA DRAGAN", PUBLIC_CELEBA + ["-nms", "1", "--mean_sample_size", "8", "--penalty",
                                       "DRAGAN"], _conv_launches),
    ("MNIST bpc", SURFACE_MNIST + ["--backprop_clip", "true", "--pallas", "true"],
     lambda n_d, n_g: {"K6": n_d, "K6 leaves": n_d}),
    ("MNIST is bpc", SURFACE_MNIST + ["-dpm", "is", "--backprop_clip", "true"],
     lambda n_d, n_g: {}),
)


@timed
def cap_kernel_checks(dev, smi):
    """K2/K3 at conv2-conv4 (bf16, tensor cores) and K4/K5 at the G's five
    norm shapes (bf16), at the Poisson buffer of batch 128 (CAP rows): each
    against its plain version to the bounds of step 4. K2/K3 with the last
    CAP - 128 rows' cotangents zero, as the mask leaves them: those rows' K2
    norms must be exactly 0, and the K3 sum and the other norms must equal
    K2/K3 over the 128 valid rows alone (to CONV_BOUND). Each timed beside
    its plain version. Returns {kernel: (ms, plain ms)}."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    g = torch.Generator(dev).manual_seed(26)
    t = {k: [0.0, 0.0] for k in ("K2", "K3", "K4", "K5")}
    for h, cin, cout in CONV_LAYERS:
        a, c, w, ks = conv_operands(g, dev, CAP, h, cin, cout, torch.bfloat16)
        c[CB:] = 0
        tag = f"conv {h}x{h}x{cin}->{cout} B {CAP} ({CAP - CB} rows masked)"
        r2, r3, _, _ = conv_held(tag, a, c, w, ks, "tc")
        nk = pcg.ghost_sq_norms(a, c, 5, 5, 2, 2)
        wk = pcg.weighted_kernel_grad(a, c, w, ks, 2, 2)
        nv = pcg.ghost_sq_norms(a[:CB], c[:CB], 5, 5, 2, 2)
        wv = pcg.weighted_kernel_grad(a[:CB], c[:CB], w[:CB], ks, 2, 2)
        torch.cuda.synchronize()
        nonzero = int(torch.count_nonzero(nk[CB:]))
        rn, rw = rel_l2(nk[:CB], nv), rel_l2(wk, wv)
        print(f"{tag}, tensor cores: K2 rel l2 {r2:.3e}, K3 rel l2 {r3:.3e} against plain "
              f"(bound {CONV_BOUND:g}); masked rows' K2 norms non-zero: {nonzero}; against "
              f"the {CB} valid rows alone: K2 {rn:.3e}, K3 {rw:.3e}")
        if nonzero or not (rn < CONV_BOUND and rw < CONV_BOUND):
            fail(f"K2/K3 at {tag}: masked rows are not zero or the valid rows' sums moved")
        for key, fk, fp in (("K2", lambda: pcg.ghost_sq_norms(a, c, 5, 5, 2, 2),
                             lambda: pcg.ghost_sq_norms_plain(a, c, 5, 5, 2, 2)),
                            ("K3", lambda: pcg.weighted_kernel_grad(a, c, w, ks, 2, 2),
                             lambda: pcg.weighted_kernel_grad_plain(a, c, w, ks, 2, 2))):
            t[key][0] += cuda_ms(fk, 10)
            t[key][1] += cuda_ms(fp, 3)
        del a, c, w
    for hw, c, mult in GN_SHAPES:
        x, dy, sc, bi = gn_operands(g, dev, CAP, hw, c, torch.bfloat16)
        gn_held(x, dy, sc, bi)
        t["K4"][0] += mult * cuda_ms(lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5), 10)
        t["K4"][1] += mult * cuda_ms(lambda: gn.gn_relu_plain(x, sc, bi, 32, 1e-5), 3)
        t["K5"][0] += mult * cuda_ms(lambda: gn.gn_relu_backward(x, dy, sc, bi, 32, 1e-5), 10)
        t["K5"][1] += mult * cuda_ms(lambda: gn.gn_relu_bwd_plain(x, dy, sc, bi, 32, 1e-5), 3)
        del x, dy
    print(f"kernels at B {CAP} [{smi}], ms by CUDA events (kernel, plain): K2 per D step "
          f"{t['K2'][0]:.4f}, {t['K2'][1]:.3f}; K3 per D step {t['K3'][0]:.4f}, "
          f"{t['K3'][1]:.3f}; K4 per G forward {t['K4'][0]:.4f}, {t['K4'][1]:.3f}; K5 per G "
          f"backward {t['K5'][0]:.4f}, {t['K5'][1]:.3f}")
    return t


@timed
def surface_bound_checks(dev, out_root, smi):
    """On the card, at sigma 0: the per-sample-penalty clipped sum (through
    K6 at std 0) has norm at most B * C (1 + 1e-5) at C 0.05, where the
    samples are clipped, on the MNIST flagship (DRAGAN, bs 600) and on
    CelebA (WGAN-GP, bs 128), with the penalty in the per-sample norms (JAX
    tests/test_steps.py:197-240); and under backprop clipping at the
    derived bounds (the Trainer's clipping) no sample is clipped, on MNIST
    rows and on rows scaled by 100 (JAX tests/test_backprop_clip.py:57-87)."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.data.mnist import synthetic_mnist
    from csl_gan_tpu_torch.ops import grads as gops
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.penalty import draw_shape

    def mnist_batch(g, bs):
        imgs, labels = synthetic_mnist(bs, seed=15)
        return torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)

    def celeba_batch(g, bs):
        return (torch.rand(bs, 64, 64, 3, generator=g, device=dev) * 2 - 1,
                torch.randint(0, 2, (bs,), generator=g, device=dev))

    g = torch.Generator(dev).manual_seed(33)
    # Two-sided penalties: a one-sided one (DRAGAN1) is 0 at the initial D,
    # whose input gradients are shorter than 1, and would not show.
    mnist = [a if a != "DRAGAN1" else "DRAGAN" for a in SURFACE_RUNS[3][1]]
    for name, argv, batch in (("MNIST", mnist, mnist_batch),
                              ("CelebA", SURFACE_RUNS[2][1], celeba_batch)):
        opt, b = _step_builder(argv + ["--sigma", "0", "-c", "0.05"], dev,
                               out_root / f"bound_{name}")
        assert b.ps_pen and b.fused_route
        st = b.init_state()
        bs, c = opt.batch_size, float(opt.clipping_param)
        x, y = batch(g, bs)
        fake = b.fakes(st.g_params, b.gen_z(g, bs), y)
        draws = [torch.rand(draw_shape(t, x.shape), generator=g, device=dev)
                 for t in b.penalty_types]
        leaves = [st.d_params[k] for k in b.d_leaves]
        fused = gops.draw_fused_noise(g, leaves, torch.zeros(len(leaves), device=dev))
        f, args = b.real_ps_args(x, y, b.row_weights(y), fake, draws)
        summed, stats = gops.clipped_grad_sum(f, st.d_params, *args, max_norm=c,
                                              fused_noise=fused)
        f0, args0 = b.real_ps_args(x, y, b.row_weights(y))
        _, stats0 = gops.clipped_grad_sum(f0, st.d_params, *args0, max_norm=c)
        norm = float(gops.global_norm(list(summed.values())))
        bound = bs * c * (1 + 1e-5)
        with_pen, without = float(stats.norm_mean.sum()), float(stats0.norm_mean.sum())
        print(f"{name} per-sample penalty ({', '.join(b.penalty_types)}; bs {bs}, C {c:g}, "
              f"sigma 0, through K6) [{smi}]: clipped sum norm {norm:.4f} <= {bound:.4f}; "
              f"clipped {float(stats.frac_clipped.mean()):.2f}; summed per-leaf norm means "
              f"with the penalty {with_pen:.4f}, without {without:.4f}")
        if not (norm <= bound and with_pen != without):
            fail(f"the {name} per-sample penalty is not inside the clip bound")
        del b, st, summed, f, args
        torch.cuda.empty_cache()
    opt = toptions.parse(SURFACE_RUNS[5][1] + ["--sigma", "0", "-ne", "1", "--manual_seed",
                                               "1", "-o", str(out_root / "bpc_bounds")])
    tr = Trainer(opt)
    b, st = tr.builder, tr.state
    leaves = [st.d_params[k] for k in b.d_leaves]
    fused = gops.draw_fused_noise(g, leaves, torch.zeros(len(leaves), device=dev))
    x, y = mnist_batch(g, opt.batch_size)
    for scale in (1.0, 100.0):
        _, m = b.d_step_gc(st, x * scale, y, b.gen_z(g, opt.batch_size), fused=fused)
        frac = m["frac_clipped"].tolist()
        print(f"MNIST bpc gc D step at the derived bounds (clipping {float(st.clipping):.6f}, "
              f"sigma 0, rows x {scale:g}) [{smi}]: clipped {frac}, norm max "
              f"{[round(v, 6) for v in m['norm_max'].tolist()]}")
        if any(v != 0.0 for v in frac):
            fail(f"backprop clipping at the derived bounds clipped samples: {frac}")
    tr.close()


def dp_surface_phase(dev, out_root, smi, k1_step_ms=None, celeba_step_ms=None):
    """The phase-10 runs through the Trainer (``cond_arch_run``: launches by
    kernel held to their expected counts, finite logs and parameters, update
    counts, epsilon, ms per D step, device-busy share, peak memory), then
    K2-K5 at the Poisson buffer of batch 128, one CelebA per-sample-penalty
    D step through K6 against K6's plain version, and the sigma-0 bound
    checks. Returns ({run: launches by kernel}, the B CAP times)."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    shutil.rmtree(out_root / "dp_surface", ignore_errors=True)
    by_run = {}
    for name, argv, counts in SURFACE_RUNS:
        launches, step_ms, tr = cond_arch_run(name, argv, out_root, smi,
                                              _surface_expect(counts), sub="dp_surface")
        ref, what = (celeba_step_ms, "the CelebA flagship's") if name.startswith("CelebA") \
            else (k1_step_ms, "the K1 path's")
        if ref:
            print(f"{name}: {step_ms:.3f} ms per D step, {step_ms / ref:.2f}x {what} "
                  f"{ref:.3f} of this run")
        if tr.builder.poisson:
            print(f"{name}: Poisson buffer of {tr.builder.poisson_cap} rows for batch "
                  f"{tr.opt.batch_size} (q {tr.builder.poisson_q:g})")
        by_run[name] = launches
        del tr
        torch.cuda.empty_cache()
    cap_ms = cap_kernel_checks(dev, smi)

    def celeba_batch(g, bs):
        return (torch.rand(bs, 64, 64, 3, generator=g, device=dev) * 2 - 1,
                torch.randint(0, 2, (bs,), generator=g, device=dev))
    clip_step_check(dev, out_root / "dp_surface", "CelebA per-sample penalty",
                    SURFACE_RUNS[2][1], celeba_batch)
    torch.cuda.empty_cache()
    surface_bound_checks(dev, out_root / "dp_surface", smi)
    print(f"DP surface phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")
    return by_run, cap_ms


# ---------------- interop: reference checkpoints, Inception FID ----------------

# The CelebA flagship at fp32, cut to 10 D steps and 2 G updates an epoch and
# logged every epoch, as a run of the reference would have written it.
INTEROP_ARGV = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "128", "-tss", "1280", "-nms",
                "1", "--mean_sample_size", "8", "--bf16", "false",
                "--train_d_until_threshold", "1e18", "--log_every", "1280", "--manual_seed", "1"]
INTEROP_FID_SAMPLES = 2048
# Inception features on the card against the CPU: fp32 convolutions (TF32
# off) in other algorithms and summation orders on the two devices, ~1e-7
# relative an op over 94 convolutions and 11 concatenated blocks.
INCEPTION_BOUND = 1e-4


@timed
def write_reference_run(root):
    """A reference-format run directory under root/ref: the opt.txt of
    INTEROP_ARGV without the JAX package's extension flags (the reference has
    none of them), and saves/G-1 and D-1 as the reference writes them
    (``torch.save({epoch, model_state_dict, optimizer_state_dict, loss})``)
    with its key names: weights seeded U(+-1/sqrt(fan_in)), biases U(+-0.1),
    GroupNorm scales 1 + U(+-0.1), and Adam's state after one step."""
    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training import ref_convert

    opt = toptions.parse(INTEROP_ARGV + ["-o", str(root / "parsed")])
    names = [a.dest for a in toptions.build_parser()._actions]
    extensions = set(names[names.index("mesh_shape"):])
    ref = root / "ref"
    (ref / "saves").mkdir(parents=True)
    with open(ref / "opt.txt", "w") as f:
        json.dump({k: v for k, v in vars(opt).items() if k not in extensions}, f)
    G, D = init_models(opt, torch.device("cpu"))
    gen = torch.Generator().manual_seed(11)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    for name, model, key_map in (("G", G, ref_convert.g_key_map(opt, G)),
                                 ("D", D, ref_convert.d_key_map(opt, D))):
        like = model.state_dict()
        sd, adam = {}, {}
        for i, (src, dst, _) in enumerate(key_map):
            shape = like[dst].shape
            if len(shape) > 1:
                sd[src] = uniform(shape, shape[1:].numel() ** -0.5)
            else:
                sd[src] = uniform(shape, 0.1) + (1.0 if "Norm" in dst and
                                                 dst.endswith("weight") else 0.0)
            g = torch.randn(shape, generator=gen) * 1e-2
            adam[i] = {"step": torch.tensor(1.0), "exp_avg": (1 - opt.adam_b1) * g,
                       "exp_avg_sq": (1 - opt.adam_b2) * g * g}
        groups = [{"lr": opt.g_lr if name == "G" else opt.d_lr,
                   "betas": (opt.adam_b1, opt.adam_b2), "eps": 1e-8, "weight_decay": 0,
                   "amsgrad": False, "params": list(range(len(key_map)))}]
        torch.save({"epoch": 0, "model_state_dict": sd,
                    "optimizer_state_dict": {"state": adam, "param_groups": groups},
                    "loss": 0.0}, ref / "saves" / f"{name}-1")
    return ref, opt


@contextlib.contextmanager
def shapes_taken(seen, k6=False):
    """K2-K5's wrappers (and K6's with ``k6``) replaced by spies that add
    (kernel, operand shapes, dtype) of each call to the set `seen` and call
    the wrapper; yields the spies (K2, K3, K4, K5[, K6]). A wrapper adds to
    its counts through its module name, so while they stand in, the counts
    (``launches``, ``launches_tc``) move on the spies."""
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn

    def spy(key, fn):
        def run(*args, **kw):
            if key == "K6":             # one record a leaf of the group
                seen.update((key, (tuple(t.shape),), t.dtype) for t in args[0])
            else:
                ops = args[:2] if key in ("K2", "K3") else args[:1]
                seen.add((key, tuple(tuple(t.shape) for t in ops), args[0].dtype))
            return fn(*args, **kw)
        run.launches = run.launches_tc = run.leaves = 0
        return run
    swaps = tuple((mod, name, spy(key, getattr(mod, name))) for key, mod, name in (
        ("K2", pcg, "ghost_sq_norms"), ("K3", pcg, "weighted_kernel_grad"),
        ("K4", gn, "gn_relu_forward"), ("K5", gn, "gn_relu_backward"))
        + ((("K6", pc, "leaves_weighted_sum_noise"),) if k6 else ()))
    with _swapped(swaps):
        yield [fn for _, _, fn in swaps]


def _timed(acc, key, fn):
    """fn, with its seconds (the card synchronized) added to acc[key] and the
    images it took to acc["n_" + key]."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        acc["n_" + key] += len(out)
        return out
    return run


def conv_flops(net, dev) -> float:
    """Operations of one image through the Inception network's convolutions
    (2 x MACs, from the output shapes of a forward at 299x299)."""
    import torch

    total = 0.0

    def count(mod, inp, out):
        nonlocal total
        kh, kw = mod.kernel_size
        total += 2.0 * out[0].numel() * mod.in_channels * kh * kw / mod.groups

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(torch.zeros(1, 299, 299, 3, device=dev))
    for h in hooks:
        h.remove()
    return total


def interop_phase(dev, out_root, smi, peak_flops):
    """Phase 11: a reference run converted, sampled, scored and resumed
    (outputs under build/chip_smoke/interop/). Returns K2-K5's launches by
    run."""
    import os
    import shutil

    import numpy as np
    import torch
    from csl_gan_tpu_torch import convert_reference_checkpoint, mem_inf_attack
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.privacy import RdpAccountant
    from csl_gan_tpu_torch.tools import fid as fid_mod
    from csl_gan_tpu_torch.tools import inception
    from csl_gan_tpu_torch.tools.saved_run import load_run
    from csl_gan_tpu_torch.training.steps import StepBuilder

    t_phase = time.perf_counter()
    root = out_root / "interop"
    shutil.rmtree(root, ignore_errors=True)
    ref, ref_opt = write_reference_run(root)
    conv = root / "converted"
    t0 = time.perf_counter()
    convert_reference_checkpoint.main([str(ref), "-o", str(conv)])
    print(f"interop [{smi}]: a reference CelebA run (celeba_g64 / celeba_d64, fp32, "
          f"upstream keys, Adam after one step) converted in {time.perf_counter() - t0:.2f} s")

    # Sampling at gensamples' batch through K4.
    opt, builder, state, _ = load_run(str(conv), 1)
    if not (opt.ref_pixel_shuffle and all(
            getattr(builder.G, f"ResBlockUp_{i}").UpsampleConv_0.ref_ps
            for i in range(builder.G.n_blocks))):
        fail("the converted run's G does not take the reference's pixel shuffle")
    g = torch.Generator(dev).manual_seed(50)
    _, k4_sample = held_samples(builder, state, builder.gen_z(g, 50), builder.gen_y(g, 50),
                                "converted reference G, pixel shuffle, fp32", smi, bf16=False)

    # mem_inf_attack --compute_fid with Inception features on the card.
    wpath = root / "inception_random_params_0.npz"
    params = inception.random_params(0)
    np.savez(wpath, **params)
    mia = root / "mia"
    acc = {"sample": 0.0, "n_sample": 0, "features": 0.0, "n_features": 0}
    old_env = os.environ.get("FID_INCEPTION_WEIGHTS")
    os.environ["FID_INCEPTION_WEIGHTS"] = str(wpath)
    gn.gn_relu_forward.launches = 0
    try:
        with clocked("mem_inf_attack --compute_fid"), _swapped(((StepBuilder, "sample_images",
                        _timed(acc, "sample", StepBuilder.sample_images)),
                       (fid_mod, "features_from_images",
                        _timed(acc, "features", fid_mod.features_from_images)))):
            t0 = time.perf_counter()
            mem_inf_attack.main([
                "--model_dir", str(root), "--model_name", "converted", "--checkpoints", "1",
                "--asr_iters", "200", "--compute_fid", "--num_generated_samples",
                str(INTEROP_FID_SAMPLES), "--public_set_size", "1280",
                "--tmp_dir", f"{mia}/tmp/", "--samples_dir", f"{mia}/samples/",
                "--values_dir", f"{mia}/values/", "--outputs_dir", f"{mia}/outputs/", "--save"])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        if old_env is None:
            os.environ.pop("FID_INCEPTION_WEIGHTS", None)
        else:
            os.environ["FID_INCEPTION_WEIGHTS"] = old_env
    k4_mia = gn.gn_relu_forward.launches
    with open(mia / "outputs" / "converted.json") as fh:
        stats = json.load(fh)["1"]
    net = inception.build(params, dev)
    flops = conv_flops(net, dev) * acc["n_features"]
    print(f"mem_inf_attack --compute_fid on the converted run [{smi}]: sampling "
          f"{acc['sample']:.2f} s ({acc['n_sample']} images, K4 calls {k4_mia}), Inception "
          f"features {acc['features']:.2f} s for {acc['n_features']} images "
          f"({acc['n_features'] / acc['features']:.1f} images/s at 299x299, fp32, TF32 off; "
          f"{flops / 1e12:.2f} TFLOP of convolutions, {flops / acc['features'] / 1e12:.2f} "
          f"TFLOP/s, {100 * flops / acc['features'] / peak_flops:.1f}% of the fp32 peak, "
          f"bound {1e3 * flops / peak_flops:.1f} ms), total {total:.2f} s; fid "
          f"{stats.get('fid')} (random weights: not a comparable FID); ASR {stats.get('asr')}")
    if "fid" not in stats or not math.isfinite(stats["fid"]) or not 0 <= stats["asr"] <= 1:
        fail(f"mem_inf_attack stats {stats}")
    if acc["n_features"] < INTEROP_FID_SAMPLES or k4_mia == 0:
        fail(f"mem_inf_attack took {acc['n_features']} images through Inception, "
             f"K4 {k4_mia} times")

    # Inception features of 100 images on the card against the CPU: on the
    # tool's random_params(0) (features up to ~1e11) and on fan-in-scaled
    # weights, whose activations stay O(1) as real weights keep them.
    z, y = builder.gen_z(g, 100), builder.gen_y(g, 100)
    imgs = ((builder.sample_images(state, z, y) + 1) / 2).cpu().numpy()
    for label, p in (("random_params(0)", params),
                     ("scaled_random_params(7), fan-in scaled",
                      inception.scaled_random_params(7))):
        with clocked(f"Inception card against CPU, {label}"):
            on_card = inception.features(inception.build(p, dev), imgs)
            t0 = time.perf_counter()
            on_cpu = inception.features(inception.build(p, torch.device("cpu")), imgs)
            cpu_s = time.perf_counter() - t0
        gap = rel_l2(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
        print(f"Inception features of 100 images on {label} [{smi}]: card against CPU "
              f"{gap:.3e} relative l2 (bound {INCEPTION_BOUND:g}), max abs gap "
              f"{float(np.abs(on_card - on_cpu).max()):.3e}; |features| up to "
              f"{float(np.abs(on_cpu).max()):.3e}; the CPU took {cpu_s:.2f} s")
        if not (gap <= INCEPTION_BOUND and np.isfinite(on_card).all()):
            fail(f"Inception features on {label} on the card do not hold to the CPU's")

    # The converted run resumed for one epoch through K2-K5.
    issued = (gn.cuda_launches(False), gn.cuda_launches(True))
    seen = set()
    with shapes_taken(seen) as wrappers:
        tr, t_init, first_ms, counts = train_run(
            ["CelebA", "-rp", str(conv), "-re", "1", "-ne", "2", "-ka", "n_epochs"], wrappers)
    tc = (wrappers[0].launches_tc, wrappers[1].launches_tc)
    issued = (gn.cuda_launches(False) - issued[0], gn.cuda_launches(True) - issued[1])
    n = tr.n_batches
    g_updates = -(-n // tr.opt.n_d_steps)
    want = [3 * n, 3 * n, 9 * (n + g_updates), 9 * g_updates]
    with open(conv / "log.csv") as fh:
        row = list(csv.reader(fh))[-1]
    logged = [float(v) for f in row[2:] for v in f.strip("[]").split()]
    with open(conv / "privacy_log.csv") as fh:
        eps = float(list(csv.reader(fh))[-1][1])
    acct = RdpAccountant(ref_opt.batch_size, ref_opt.train_set_size, ref_opt.sigma)
    acct.step(2 * n)
    want_eps = acct.get_privacy_spent(ref_opt.delta)[0] + tr.mean_sample_privacy_cost
    print(f"converted run resumed for 1 epoch [{smi}]: {n} D steps, {g_updates} G updates, "
          f"K2/K3/K4/K5 launches {counts} (expected {want}); Trainer with its loads "
          f"{t_init:.2f} s, the epoch {first_ms:.3f} ms ({first_ms / n:.3f} ms per D step); "
          f"epsilon {eps:.6f} (an accountant of {2 * n} steps plus the mean samples: "
          f"{want_eps:.6f}); logged {row}")
    if counts != want:
        fail(f"the resumed run's launches {counts}, expected {want}")
    if (tr.state.d_count, tr.state.g_count) != (1 + n, 1 + g_updates):
        fail(f"D / G counts {tr.state.d_count} / {tr.state.g_count} after the resume")
    if not (all(math.isfinite(v) for v in logged) and math.isclose(eps, want_eps,
                                                                  rel_tol=1e-12)):
        fail(f"the resumed run logged {row}, epsilon {eps}")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail("non-finite params after the resume")
    # K2-K5 held against their plain versions at the shapes the resume gave
    # them: fp32 operands at B 128, so K2/K3 in their FFMA variant.
    f32 = torch.float32
    shapes = ({(k, ((CB, h, h, cin), (CB, h // 2, h // 2, cout)), f32)
               for k in ("K2", "K3") for h, cin, cout in CONV_LAYERS}
              | {(k, ((CB, hw, c),), f32) for k in ("K4", "K5") for hw, c, _ in GN_SHAPES})
    if seen != shapes:
        fail(f"the resumed run gave K2-K5 {sorted(seen, key=str)}, expected "
             f"{sorted(shapes, key=str)}")
    if tc != (0, 0):
        fail(f"K2/K3 took the tensor-core variant {tc} times on the fp32 resume")
    # CUDA launches a G pass by the plans: a K4 call one (one pass) or three,
    # a K5 call two or six.
    per_g = [(2 if bw else 1) * sum(
        m * (1 if gn.launch_plan(CB, hw, c, 32, f32, bw)[0] == gn.ONE_PASS else 3)
        for hw, c, m in GN_SHAPES) for bw in (False, True)]
    want_issued = (counts[2] // G_NORMS * per_g[0], counts[3] // G_NORMS * per_g[1])
    print(f"the resume's K4 / K5 CUDA launches {issued} (counted where issued; the plans' "
          f"{want_issued}); K2/K3 tensor-core launches {tc}")
    if issued != want_issued:
        fail(f"the resume issued K4 / K5 CUDA launches {issued}, expected {want_issued}")
    gk = torch.Generator(dev).manual_seed(24)
    for h, cin, cout in CONV_LAYERS:                 # (timed with the resume's shapes)
        r2, r3, _, _ = conv_held(f"fp32 conv {h}x{h}x{cin}->{cout} (B {CB})",
                                 *conv_operands(gk, dev, CB, h, cin, cout, f32), "ffma")
        print(f"conv {h}x{h}x{cin}->{cout} fp32 (B {CB}, the resume's shape), FFMA: K2 rel l2 "
              f"{r2:.3e}, K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")
    for hw, c, _ in GN_SHAPES:
        gn_held(*gn_operands(gk, dev, CB, hw, c, f32))
    print(f"interop phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")
    return {"sample_b50": {"K4": k4_sample}, "mem_inf_attack": {"K4": k4_mia},
            "resume": dict(zip(("K2", "K3", "K4", "K5"), counts))}


# ---------------- the rest of the single-device surface ----------------

# Phase 12: each run one epoch through the Trainer. MNIST at the flagship's
# flags (bs 600, 100 steps an epoch, nothing cut); CelebA at the flagship's
# flags cut as path 2 is (-tss 1280: 10 D steps, 2 G updates an epoch). The
# two flagships run first, as the references of the phase's ms per D step.
SURF_MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
              "-tss", "60000", "--log_every", "60000"]
SURF_CELEBA = PUBLIC_CELEBA + ["-nms", "1", "--mean_sample_size", "8", "--log_every", "1280"]
SURF_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K6 leaves", "K2 tc", "K3 tc")
# The sub-epoch cadence: a log row and a grid every 20 of the 100 steps.
SURF_CADENCE = 12000
# The grouped CelebA epoch against the per-batch one. Two per-batch runs of
# one seed are bitwise equal on the card (default or deterministic cuDNN
# alike), so the witness is the per-batch epoch with each D step's fakes
# moved as the batched forward moves them: on the share of elements where
# the 640-row forward's fakes differ from the per-step forwards' (measured
# on the same G and z), by their median relative gap, with a random sign.
# The grouped epoch is held to 3x that witness's gap.
SURF_GROUP_FACTOR = 3.0
# Real-format CelebA: JPEGs of the aligned set's size, and threads of the
# native decoder (-nw, the Trainer's default).
SURF_JPEGS, SURF_JPEG_SIZE, SURF_THREADS = 1280, (178, 218), 8


def _mnist_expect(k1):
    return lambda n_d, n_g: {"K1": k1}


def _celeba_expect(n_d, n_g, fakes=None):
    out = _conv_launches(n_d, n_g)
    if fakes is not None:
        out["K4"] = G_NORMS * (fakes + n_g)
    return out


@contextlib.contextmanager
def k4_batches(counter):
    """K4's wrapper replaced by a spy that counts its launches by batch in
    ``counter`` and delegates; the wrapper's count moves on the spy."""
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    fn = gn.gn_relu_forward

    def spy(x3, *args, **kw):
        before = spy.launches
        out = fn(x3, *args, **kw)
        if spy.launches > before:
            counter[x3.shape[0]] += 1
        return out
    spy.launches = 0
    with _swapped(((gn, "gn_relu_forward", spy),)):
        yield spy


def surface_run(name, argv, root, smi, expect, capture=False, setup=None):
    """One epoch of ``argv`` through the Trainer, every kernel's launches
    counted (K4's also by batch) and held to ``expect(D steps, G updates)``;
    finite logs and parameters, the update counts and epsilon against the
    port's accountant recomputed for the steps plus the mean samples' cost.
    Returns a dict: launches, ms per D step (CUDA events over the epoch),
    the Trainer, its output directory, K4's launches by batch and, with
    ``capture``, what the run printed. ``setup(trainer)`` runs before the
    epoch."""
    import collections
    import io

    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    from csl_gan_tpu_torch.privacy import RdpAccountant
    from csl_gan_tpu_torch.training.loop import Trainer

    out = root / name.replace(" ", "_").replace("-", "")
    opt = toptions.parse(argv + ["-ne", "1", "--manual_seed", "1", "-o", str(out)])
    t0 = time.perf_counter()
    tr = Trainer(opt)
    t_init = time.perf_counter() - t0
    if setup is not None:
        setup(tr)
    by_batch = collections.Counter()
    printed = io.StringIO()
    with k4_batches(by_batch) as k4:
        wrappers = {"K1": pe.epoch_kernel, "K2": pcg.ghost_sq_norms,
                    "K3": pcg.weighted_kernel_grad, "K4": k4, "K5": gn.gn_relu_backward,
                    "K6": pc.leaves_weighted_sum_noise}
        for w in wrappers.values():
            w.launches = 0
        pc.leaves_weighted_sum_noise.leaves = 0
        pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed) if capture else contextlib.nullcontext():
            tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        launches["K6 leaves"] = pc.leaves_weighted_sum_noise.leaves
    launches["K2 tc"], launches["K3 tc"] = (pcg.ghost_sq_norms.launches_tc,
                                            pcg.weighted_kernel_grad.launches_tc)
    n = tr.n_batches
    ms = sum(a.elapsed_time(b) for a, b in tr.runner.epoch_events) / n
    with open(out / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    vals = [float(x) for r in rows for key, cell in r.items()
            if key not in ("Epoch", "Batch") for x in cell.strip("[]").split()]
    if not rows or not all(math.isfinite(v) for v in vals):
        fail(f"{name}: no log row or non-finite log values")
    with open(out / "privacy_log.csv") as fh:
        eps = [float(r["Epsilon"]) for r in csv.DictReader(fh)]
    acc = RdpAccountant(opt.batch_size, opt.train_set_size, opt.sigma)
    acc.step(n)
    want_eps = acc.get_privacy_spent(opt.delta)[0] + tr.mean_sample_privacy_cost
    if len(eps) != 1 or not math.isclose(eps[-1], want_eps, rel_tol=1e-12):
        fail(f"{name}: epsilon {eps}, expected {want_eps} after {n} steps")
    if not all(torch.isfinite(t).all() for p in (tr.state.d_params, tr.state.g_params)
               for t in p.values()):
        fail(f"non-finite params after {name}")
    g_updates = -(-n // opt.n_d_steps)
    if tr.state.d_count != n or tr.state.g_count != g_updates:
        fail(f"{name}: D / G update counts {tr.state.d_count} / {tr.state.g_count}")
    want = dict.fromkeys(SURF_KERNELS, 0)
    want.update(expect(n, g_updates))
    want["K2 tc"], want["K3 tc"] = want["K2"], want["K3"]
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    print(f"{name} [{smi}]: 1 epoch of {n} D steps ({g_updates} G updates) on the "
          f"{type(tr.runner).__name__}, launches {launches}"
          + (f", K4 by batch {dict(sorted(by_batch.items()))}" if by_batch else "")
          + f"; {ms:.3f} ms per D step; epsilon {eps[-1]:.6f}; {len(rows)} log row(s), "
          f"last D Adv Loss {float(rows[-1]['D Adv Loss']):.4f}; Trainer built in "
          f"{t_init:.2f} s, run {wall:.2f} s")
    return {"launches": launches, "ms": ms, "tr": tr, "out": out, "k4_batches": by_batch,
            "printed": printed.getvalue()}


def _state_gap(a, b) -> float:
    """The largest relative l2 gap over the parameter and Adam groups of two
    TrainStates."""
    import torch
    worst = 0.0
    for group in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu"):
        u, v = getattr(a, group), getattr(b, group)
        worst = max(worst, rel_l2(torch.cat([u[k].float().reshape(-1) for k in v]),
                                  torch.cat([v[k].float().reshape(-1) for k in v])))
    return worst


def write_celeba_jpegs(root):
    """SURF_JPEGS numbered JPEGs of SURF_JPEG_SIZE and a list_attr_celeba.txt
    with all 40 columns, in the layout data/celeba.py reads (the fixture of
    JAX tests/test_real_celeba.py:25-47). Returns (image dir, attr file)."""
    import numpy as np
    from PIL import Image
    from csl_gan_tpu_torch.data.celeba import CELEBA_ATTR

    img = root / "img_align_celeba"
    img.mkdir(parents=True)
    rng = np.random.default_rng(12)
    w, h = SURF_JPEG_SIZE
    for i in range(SURF_JPEGS):
        base = rng.integers(0, 256, (1, 1, 3)) + rng.integers(-40, 40, (h, w, 3))
        Image.fromarray(np.clip(base, 0, 255).astype(np.uint8)).save(
            img / f"{i + 1:06d}.jpg", quality=90)
    attrs = CELEBA_ATTR[1:]
    male = attrs.index("Male")
    attr_file = root / "list_attr_celeba.txt"
    with open(attr_file, "w") as f:
        f.write(f"{SURF_JPEGS}\n" + " ".join(attrs) + "\n")
        for i in range(SURF_JPEGS):
            row = [-1] * len(attrs)
            row[male] = 1 if i % 3 == 0 else -1
            f.write(f"{i + 1:06d}.jpg " + " ".join(map(str, row)) + "\n")
    return img, attr_file


@timed
def surface_decode(root, smi):
    """The real-format files decoded into the cache twice, cold (the native
    decoder, which must run) and memory-mapped, and once by PIL alone (into
    another cache), each timed. Returns (image dir, attr file, images/s:
    native, PIL)."""
    import numpy as np
    from csl_gan_tpu_torch.data import celeba, native

    t0 = time.perf_counter()
    img, attr = write_celeba_jpegs(root)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        fail(f"the native decoder did not build: {native.why_unavailable}")
    t_build = time.perf_counter() - t0
    ds = celeba.CelebADataset(str(img), 64, length=SURF_JPEGS, attr_file=str(attr),
                              attr="Male")
    cold, labels = ds.decoded_cache(n_threads=SURF_THREADS)
    st = dict(ds.decode_stats)
    if not st["decoder"].startswith("native") or st["pil"]:
        fail(f"the native decoder did not decode the cache ({st}; {native.why_unavailable})")
    warm, _ = ds.decoded_cache()
    mm = dict(ds.decode_stats)
    if mm["decoder"] != "cache" or not isinstance(warm, np.memmap):
        fail(f"the second decode did not memory-map the cache ({mm})")
    with _swapped(((native, "available", lambda: False),)):
        pds = celeba.CelebADataset(str(img), 64, length=SURF_JPEGS, attr_file=str(attr),
                                   attr="Male")
        pil, _ = pds.decoded_cache(cache_dir=str(root / "pil_cache"))
    pst = pds.decode_stats
    gap = int(np.abs(pil.astype(np.int16) - np.asarray(cold, np.int16)).max())
    nat_ips, pil_ips = SURF_JPEGS / st["seconds"], SURF_JPEGS / pst["seconds"]
    print(f"CelebA decode-once cache [{smi}]: {SURF_JPEGS} JPEGs of {SURF_JPEG_SIZE[0]}x"
          f"{SURF_JPEG_SIZE[1]} written in {t_write:.2f} s; the decoder built and loaded "
          f"in {t_build:.2f} s; decoded to 64x64 by the "
          f"{st['decoder']} decoder (libjpeg: {native.link}) in {st['seconds']:.3f} s, "
          f"{nat_ips:.0f} images/s; again memory-mapped in {mm['seconds'] * 1e3:.2f} ms; "
          f"by PIL alone in {pst['seconds']:.3f} s, {pil_ips:.0f} images/s "
          f"({nat_ips / pil_ips:.1f}x); native against PIL max {gap} LSB; labels Male "
          f"{int(labels.sum())} of {SURF_JPEGS}")
    if gap > 1:
        fail(f"the native decode is {gap} LSB from PIL's")
    return img, attr, nat_ips, pil_ips


@timed
def b640_kernel_checks(dev, smi):
    """K4/K5 at the G's five norm shapes at the grouped batch (B 640, bf16)
    against their plain versions, K4 timed beside its plain version.
    Returns (K4 ms, plain ms) per G forward."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    g = torch.Generator(dev).manual_seed(41)
    t = [0.0, 0.0]
    b640 = 5 * CB
    for hw, c, mult in GN_SHAPES:
        x, dy, sc, bi = gn_operands(g, dev, b640, hw, c, torch.bfloat16)
        gn_held(x, dy, sc, bi)
        t[0] += mult * cuda_ms(lambda: gn.gn_relu_forward(x, sc, bi, 32, 1e-5), 10)
        t[1] += mult * cuda_ms(lambda: gn.gn_relu_plain(x, sc, bi, 32, 1e-5), 3)
        del x, dy
    print(f"K4 at B {b640} [{smi}], ms per G forward by CUDA events: {t[0]:.4f}, plain "
          f"{t[1]:.3f}")
    return t


def surface_phase(dev, out_root, smi, warm_up=False):
    """Phase 12 (outputs under build/chip_smoke/surface/): the single-device
    flags through the Trainer, K4 at the grouped batch against its plain
    version, the decode-once cache on real-format files. ``warm_up``: each
    flagship runs once first to warm a fresh process (``--surface`` alone;
    in the full run phases 3-4 have warmed it). Returns ({run: launches by
    kernel}, {"K4": (ms, plain ms) at B 640}, decode images/s)."""
    import shutil

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    root = out_root / "surface"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs = {}

    def run(name, argv, expect, **kw):
        r = surface_run(name, argv, root, smi, expect, **kw)
        runs[name] = r["launches"]
        return r

    # The flagships, the phase's references (each run once before to warm a
    # fresh process: cuDNN, the kernels' first calls).
    if warm_up:
        surface_run("MNIST warm-up", SURF_MNIST, root, smi, _mnist_expect(1))
    mnist = run("MNIST flagship", SURF_MNIST, _mnist_expect(1))
    if warm_up:
        surface_run("CelebA warm-up", SURF_CELEBA, root, smi, _celeba_expect)
    celeba = run("CelebA flagship", SURF_CELEBA, _celeba_expect)
    ref = {"MNIST": mnist["ms"], "CelebA": celeba["ms"]}

    def beside(r, model):
        print(f"  {r['ms']:.3f} ms per D step, {r['ms'] / ref[model]:.2f}x the {model} "
              f"flagship's {ref[model]:.3f} of this run")

    for name, extra in (("MNIST -wd", ["-wd", "1e-4"]), ("MNIST u8 table", ["--u8_table", "true"]),
                        ("MNIST bf16", ["--bf16", "true"])):
        r = run(name, SURF_MNIST + extra, _mnist_expect(0))
        beside(r, "MNIST")
        if name == "MNIST u8 table":
            tr = r["tr"]
            if tr.table.dtype != torch.uint8 or tr.builder.onehot_in_table:
                fail("--u8_table did not store the uint8 [x * 255 | label] table")
            idx = torch.arange(BS, device=dev)
            x, _ = tr._gather(idx)
            torch.cuda.synchronize()
            u8 = tr.table[:BS, :F].cpu().numpy()
            want = (u8.astype(np.float64) / 255.0).astype(np.float32).reshape(x.shape)
            ulp = int(np.max(np.abs(x.cpu().numpy().view(np.int32).astype(np.int64)
                                    - want.view(np.int32))))
            src = np.asarray(tr.dataset.images[:BS], np.float32)
            quant = float(np.abs(x.cpu().numpy() - src).max())
            print(f"  u8 table on the card: {tuple(tr.table.shape)} uint8; a gathered batch "
                  f"of {BS} rows dequantized within {ulp} ulp of the fp32 values of its "
                  f"stored pixels (u8 / 255 exactly rounded); the synthetic MNIST pixels are "
                  f"not on the 1/255 grid, so the batch is {quant:.3e} from the fp32 "
                  f"table's (bound 1/510)")
            if ulp > 1 or quant > 1 / 510 + 1e-7:
                fail(f"the u8 table's batch is {ulp} ulp from its pixels")
        del r

    cad = run("MNIST sub-epoch cadence", SURF_MNIST + ["--log_every", str(SURF_CADENCE),
                                                       "--sample_every", str(SURF_CADENCE)],
              _mnist_expect(60000 // SURF_CADENCE))
    beside(cad, "MNIST")
    with open(cad["out"] / "log.csv") as fh:
        progress = [float(r["Batch"]) for r in csv.DictReader(fh)]
    grids = sorted(p.name for p in (cad["out"] / "samples").iterdir())
    step = SURF_CADENCE // BS
    want_p = [100.0 * (k - 1) / (60000 / BS) for k in range(step, 60000 // BS + 1, step)]
    want_g = sorted(f"1-{k - 1}.png" for k in range(step, 60000 // BS + 1, step))
    print(f"  log.csv epoch progress {progress}, grids {grids}: K1 once a segment "
          f"({cad['launches']['K1']} launches for {len(want_p)} segments)")
    if progress != want_p or grids != want_g:
        fail(f"sub-epoch cadence: progress {progress} / grids {grids}, the JAX Trainer's "
             f"cadence gives {want_p} / {want_g}")
    del cad

    # --group_fakes against the per-batch epoch, same seed.
    grouped = run("CelebA group_fakes", SURF_CELEBA + ["--group_fakes", "true"],
                  lambda n_d, n_g: _celeba_expect(n_d, n_g, fakes=1 + -(-(n_d - 1) // 5)))
    beside(grouped, "CelebA")
    want_b = {CB: 1 + 2, 5 * CB: 1, 4 * CB: 1}
    got_b = {b: c // G_NORMS for b, c in grouped["k4_batches"].items()}
    if got_b != want_b or any(c % G_NORMS for c in grouped["k4_batches"].values()):
        fail(f"--group_fakes: K4 G forwards by batch {got_b}, expected {want_b}")
    again = surface_run("CelebA per-batch again", SURF_CELEBA, root, smi, _celeba_expect)
    repeat = _state_gap(again["tr"].state, celeba["tr"].state)
    # How the batched forward moves the fakes, on the reference's end state.
    b, st = celeba["tr"].builder, celeba["tr"].state
    g = torch.Generator(dev).manual_seed(43)
    z, y = b.gen_z(g, CB, (5,)), b.gen_y(g, CB, (5,))
    each = torch.stack([b.fakes(st.g_params, z[s], y[s]) for s in range(5)]).float()
    diff = b.batch_fakes(st, z, y).float() - each
    moved = diff != 0
    share = float(moved.float().mean())
    rel = float((diff[moved].abs() / each[moved].abs().clamp_min(1e-30)).median()) \
        if share else 0.0
    gm = torch.Generator(dev).manual_seed(44)

    def fakes_moved(tr):
        forward = tr.builder.fakes

        def fakes(g_params, zz, yy):
            f = forward(g_params, zz, yy)
            on = torch.rand(f.shape, generator=gm, device=f.device) < share
            sign = torch.rand(f.shape, generator=gm, device=f.device) < 0.5
            return torch.where(on, f * torch.where(sign, 1 - rel, 1 + rel), f)
        tr.builder.fakes = fakes

    moved_run = surface_run("CelebA per-batch, fakes moved", SURF_CELEBA, root, smi,
                            _celeba_expect, setup=fakes_moved)
    witness = _state_gap(moved_run["tr"].state, celeba["tr"].state)
    gap = _state_gap(grouped["tr"].state, celeba["tr"].state)
    print(f"  the 640-row forward moves {share:.3e} of the fakes' elements by a median "
          f"{rel:.3e} relative; grouped epoch against the per-batch one (same seed): "
          f"{gap:.3e}; two per-batch runs {repeat:.3e}; witness, the per-batch epoch with "
          f"its fakes moved so: {witness:.3e}; held to {SURF_GROUP_FACTOR:g}x")
    if gap > SURF_GROUP_FACTOR * max(witness, repeat):
        fail(f"the grouped epoch leaves the per-batch one by {gap:.3e}, over "
             f"{SURF_GROUP_FACTOR:g}x the witness {witness:.3e}")
    del grouped, again, moved_run
    torch.cuda.empty_cache()
    # K4 (and K5) at the grouped batch against the plain versions, timed.
    t = b640_kernel_checks(dev, smi)

    # Real-format CelebA: the cache, then the flagship from it and the host loop.
    img, attr, nat_ips, pil_ips = surface_decode(root / "celeba_files", smi)
    files = ["-d", str(img), "-lp", str(attr)]
    for name, extra in (("CelebA cache", []), ("CelebA host loop", ["--host_loop", "true"])):
        r = run(name, SURF_CELEBA + files + extra, _celeba_expect)
        beside(r, "CelebA")
        tr = r["tr"]
        if (tr.host_loader is not None) != bool(extra) or tr.dataset.label_true_count != \
                -(-SURF_JPEGS // 3):
            fail(f"{name}: the dataset is not the files' ({type(tr.dataset).__name__})")
        del r, tr

    prof = run("CelebA profile", SURF_CELEBA + ["-p"], _celeba_expect, capture=True)
    text = prof["printed"]
    trace = prof["out"] / "profile" / "trace.json"
    table = [ln for ln in text.splitlines() if "Self CUDA time total" in ln]
    summary = text[text.find("=== Training profile"):] if "=== Training profile" in text else ""
    lines = text.splitlines()
    first = next((i for i, ln in enumerate(lines) if ln.startswith("-----")), len(lines))
    last = next((i for i, ln in enumerate(lines) if "Self CUDA time total" in ln), first)
    print("\n".join(lines[first:last + 1]))
    print(summary)
    print(f"  -p: trace {trace.name} {trace.stat().st_size / 2**20:.1f} MiB under profile/; "
          f"{prof['ms']:.3f} ms per D step with the sections' synchronizations")
    if not (trace.exists() and table and "group_run" in summary and "checkpoint" in summary):
        fail("-p wrote no trace, or printed no key-averages table or section summary")
    del prof
    print(f"surface phase [{smi}]: {time.perf_counter() - t_phase:.1f} s")
    return runs, {"K4": tuple(t)}, (nat_ips, pil_ips)


# ---------------- multi-device training ----------------

# Phase 13: the data axis (csl_gan_tpu_torch/parallel) on the card's machine,
# which shows one card. NCCL refuses two ranks on one device, so two
# --multihost processes share the card over gloo (which carries the CUDA
# tensors of all_reduce and broadcast through the host; LOCAL_WORLD_SIZE
# tells each that it shares), and one --multihost process runs NCCL alone.
# Each run is PAR_EPOCHS epochs (one: no check of the phase resumes a run;
# the 2-rank CelebA state was 0.159 from one rank's after one epoch, 0.733
# after two, on an H100), its ms per D step the last epoch's: with one epoch
# they hold the first calls of the process (deterministic cuDNN, no
# autotuning). Each rank is a process of its own
# (``--parallel-rank``), which sets every wrapper's count to 0 just before it
# trains and reads them just after, and records the shapes it gave K2-K6.
PAR_RANKS, PAR_EPOCHS = 2, 1
PAR_CELEBA = SURF_CELEBA                    # 10 D steps, 2 G updates an epoch; B 64 a rank
PAR_PATH1 = PATH1[:PATH1.index("-tss")] + ["-tss", "6000"] + PATH1[PATH1.index("-tss") + 2:]
PAR_MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", str(BS),
             "-tss", "6000"]
# The bf16 CelebA states against the one-rank run's, group by group (params
# and Adam moments of D and of G, relative l2): each group within 3x its
# witness, the one-rank run computing every pass in the ranks' halves
# (``in_halves``), or within 3x PAR_FLOOR where the witness reads less. Two
# one-rank runs are bitwise equal. PAR_FLOOR is eight fp32 ulps: the ranks
# add the noise and their sums in another order than one device (D's params
# 7.9e-8 from one rank after one step on an H100).
PAR_FACTOR = 3.0
PAR_FLOOR = 2.0 ** -20
# The fp32 MNIST runs against their one-rank runs: relative l2 over each
# group of params and Adam moments. The ranks' sums differ from the one
# device's by their order only (~8e-8 after 20 steps on an H100).
PAR_FP32_BOUND = 1e-4
PAR_TIMEOUT = 300


@contextlib.contextmanager
def par_counted(counts):
    """Every kernel's launches over the block into ``counts``: each
    wrapper's count from 0, the tensor-core K2/K3, and K4/K5's CUDA
    launches where gn_relu.cu issues them."""
    import torch
    from csl_gan_tpu_torch.ops import pallas_clip as pc
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    from csl_gan_tpu_torch.ops import pallas_epoch as pe
    from csl_gan_tpu_torch.ops import pallas_groupnorm as gn
    wrappers = {"K1": pe.epoch_kernel, "K2": pcg.ghost_sq_norms, "K3": pcg.weighted_kernel_grad,
                "K4": gn.gn_relu_forward, "K5": gn.gn_relu_backward,
                "K6": pc.leaves_weighted_sum_noise}
    issued = (gn.cuda_launches(), gn.cuda_launches(True))
    for w in wrappers.values():
        w.launches = 0
    pc.leaves_weighted_sum_noise.leaves = 0
    pcg.ghost_sq_norms.launches_tc = pcg.weighted_kernel_grad.launches_tc = 0
    yield
    torch.cuda.synchronize()
    counts.update({k: w.launches for k, w in wrappers.items()})
    counts["K6 leaves"] = pc.leaves_weighted_sum_noise.leaves
    counts["K2 tc"], counts["K3 tc"] = (pcg.ghost_sq_norms.launches_tc,
                                        pcg.weighted_kernel_grad.launches_tc)
    counts["K4 cuda"] = gn.cuda_launches() - issued[0]
    counts["K5 cuda"] = gn.cuda_launches(True) - issued[1]


@contextlib.contextmanager
def par_taken(counts, seen):
    """``par_counted`` into ``counts`` and ``shapes_taken`` (K2-K6) into
    ``seen`` over the block: the spies stand in first, so the counts are
    theirs."""
    with shapes_taken(seen, k6=True), par_counted(counts):
        yield


def shapes_json(seen):
    return sorted([k, [list(s) for s in shapes], str(dt).replace("torch.", "")]
                  for k, shapes, dt in seen)


def shapes_of(rows):
    import torch
    return {(k, tuple(tuple(s) for s in shapes), getattr(torch, dt)) for k, shapes, dt in rows}


@contextlib.contextmanager
def in_halves(builder):
    """The one-device ``builder`` computing every batched pass in the
    PAR_RANKS parts of rows that ``torch.tensor_split`` gives the ranks: G's
    and D's forwards (so their backwards too) and the conv-ghost real pass,
    whose clipped sums add. The parts' gradients add in autograd as the
    ranks' all-reduce adds them. Nothing of ``parallel/`` takes part: the
    witness of what splitting the batch does to the arithmetic alone. The
    real pass's clip statistics (metrics only) are the first part's. A
    BatchNorm G is refused (its statistics would be a part's)."""
    import torch
    from csl_gan_tpu_torch.ops import conv_ghost
    if builder.g_has_bn:
        fail("in_halves: a BatchNorm G's statistics depend on the batch")
    g_fwd, d_fwd, real = builder.G.forward, builder.D.forward, conv_ghost.dcresnet_real_ghost

    def parts(t):
        return [None] * PAR_RANKS if t is None else torch.tensor_split(t, PAR_RANKS)

    def g_forward(z, y=None, *a, **kw):
        return torch.cat([g_fwd(zi, yi, *a, **kw) for zi, yi in zip(parts(z), parts(y))])

    def d_forward(x, y=None, *a, **kw):
        outs = [d_fwd(xi, yi, *a, **kw) for xi, yi in zip(parts(x), parts(y))]
        return tuple(None if o[0] is None else torch.cat(o) for o in zip(*outs))

    def real_ghost(d_params, x, y, *, row_w=None, valid=None, **kw):
        res = [real(d_params, xi, yi, row_w=wi, valid=vi, **kw)
               for xi, yi, wi, vi in zip(parts(x), parts(y), parts(row_w), parts(valid))]
        if kw.get("norms_only"):
            return torch.cat(res, dim=1)
        summed = {k: sum(r[0][k] for r in res) for k in res[0][0]}
        outs = tuple(None if o[0] is None else torch.cat(o) for o in zip(*(r[2] for r in res)))
        return summed, res[0][1], outs

    with _swapped(((builder.G, "forward", g_forward), (builder.D, "forward", d_forward),
                   (conv_ghost, "dcresnet_real_ghost", real_ghost))):
        yield


def _last_epoch_ms(tr) -> float:
    a, b = tr.runner.epoch_events[-1]
    return a.elapsed_time(b) / tr.n_batches


def _finite(st) -> bool:
    import torch
    return all(bool(torch.isfinite(t).all()) for f in ("d_params", "d_mu", "d_nu", "g_params",
                                                       "g_mu", "g_nu")
               for t in getattr(st, f).values())


def parallel_step_rank(job) -> None:
    """The step check's job on one rank: the payload's D step and G step
    (the global batch's inputs) on this rank's rows (and, under --tp, its
    channels), replicated and, on the data axis alone, under --fsdp; rank 0
    saves each whole state after the steps, the launches, the shapes K2-K6
    took and the D step's ms (host clock around it, the card synchronized)."""
    import dataclasses

    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.parallel import launch
    from csl_gan_tpu_torch.training.steps import StepBuilder

    opt = toptions.parse(job["argv"])
    mesh = launch.init_multihost(opt)
    try:
        G, D = init_models(opt, mesh.device)
        payload = torch.load(job["payload"], map_location=mesh.device, weights_only=False)
        out = {"shapes": set()}
        for fsdp in (False,) if mesh.tp > 1 else (False, True):
            tb = StepBuilder(opt, G, D, mesh=dataclasses.replace(mesh, fsdp=fsdp))
            counts = {}
            with par_taken(counts, out["shapes"]):
                st, dm, d_ms = tb.shard_state(payload["state"]), None, None
                if "d" in payload:      # else the G step alone
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, dm = tb.d_core(st, **payload["d"])
                    torch.cuda.synchronize()
                    d_ms = (time.perf_counter() - t0) * 1e3
                st, gm = tb.g_core(st, *payload["g"])
            whole = tb.full_state(st)
            out[fsdp] = {"state": whole, "launches": counts, "d": dm, "g": gm, "d_ms": d_ms}
        if mesh.is_main:
            torch.save(out, job["report"])
    finally:
        launch.dist.destroy_process_group()


def parallel_train_rank(job) -> None:
    """A training job on one rank: ``train.main`` on the job's argv (a
    --multihost process), its launches counted and its kernels' shapes
    recorded (``par_taken``); the report (launches, shapes, ms per D step
    of the last epoch by CUDA events, the state's bytes and what the job
    holds allocated on the card at its end) goes to the job's JSON file."""
    import gc

    import torch
    from csl_gan_tpu_torch import train

    gc.collect()
    base = torch.cuda.memory_allocated()
    counts, seen = {}, set()
    t0 = time.perf_counter()
    with par_taken(counts, seen):
        tr = train.main(job["argv"])
    wall = time.perf_counter() - t0
    st = tr.state
    report = {"rank": tr.mesh.rank, "world": tr.mesh.world, "backend": tr.mesh.backend,
              "fsdp": tr.mesh.fsdp, "launches": counts, "shapes": shapes_json(seen),
              "n": tr.n_batches, "ms": _last_epoch_ms(tr), "wall_s": wall,
              "runner": type(tr.runner).__name__, "state_bytes": _state_mb(st) * 2 ** 20,
              "allocated": torch.cuda.memory_allocated() - base, "finite": _finite(st),
              "counts": [st.d_count, st.g_count]}
    with open(job["report"], "w") as fh:
        json.dump(report, fh)


def parallel_rank(spec_json: str) -> int:
    """One rank process of phases 13 and 14 (``chip_smoke.py --parallel-rank
    <json>``): its jobs in turn, each in a process group of its own (a step
    check with a payload, else a training run)."""
    import torch
    spec = json.loads(spec_json)
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Deterministic cuDNN, as in the main process (``pinned_cudnn``): the
    # bf16 G step's weight gradients then take the same algorithms in the
    # ranks and in the one-rank witness.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    print("job_seconds " + json.dumps({"start-up": time.time() - spec["t0"]}), flush=True)
    with mnist_made_once():
        run_jobs(spec["jobs"])
    return 0


def run_jobs(jobs) -> None:
    """A rank process's jobs in turn, each timed, with its peak memory."""
    import torch
    for job in jobs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        (parallel_step_rank if job.get("payload") else parallel_train_rank)(job)
        print("job_seconds " + json.dumps({job["name"]: time.perf_counter() - t0}), flush=True)
        print("job_peak_gib " + json.dumps(
            {job["name"]: torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)


class RankSets:
    """Rank jobs on the card, on sets of ``--multihost`` processes that all
    start at once: each set (ranks, [(name, argv, step payload or None)])
    is ``ranks`` processes (``LOCAL_WORLD_SIZE`` ``ranks``: they share the
    card) that run its jobs in turn, each for PAR_EPOCHS epochs on a store
    and in an output directory of its own. Each job's store listens here
    before any rank exists (``launch.held_store``) and serves until
    ``wait()`` has reaped every rank; the ranks join it as clients
    (torchrun's agent store, ``launch.AGENT_STORE_ENV``) at
    ``--coordinator_address``. ``wait()`` returns {job name: (its
    reports by rank, or with a payload rank 0's saved results; rank 0's
    output directory)}. Each process writes its output to a log beside the
    jobs' reports."""

    def __init__(self, sets, root):
        import os

        from csl_gan_tpu_torch.parallel import launch

        self.sets, self.procs, self.jobs, self.stores = sets, [], {}, []
        self.t0 = time.perf_counter()
        for k, (ranks, jobs) in enumerate(sets):
            dirs = []
            for name, argv, payload in jobs:
                tag = name.replace(" ", "_").replace("-", "")
                (root / (tag + "_reports")).mkdir(parents=True, exist_ok=True)
                self.stores.append(launch.held_store(ranks))
                dirs.append((root / tag, root / (tag + "_reports"),
                             ".pt" if payload else ".json", self.stores[-1].port))
                self.jobs[name] = (ranks, payload, dirs[-1])
                if CLOCK is not None:
                    CLOCK.driven.add(("rank step" if payload else "rank run", config_key(
                        argv + ["--multihost", "true", "--num_processes", str(ranks)])))
            logs = root / f"{dirs[0][1].name}_set"
            for r in range(ranks):
                spec = {"t0": time.time(), "jobs": [
                    {"name": name,
                     "argv": argv + ["-ne", str(PAR_EPOCHS), "--manual_seed", "1", "-o",
                                     str(out), "--multihost", "true", "--coordinator_address",
                                     f"localhost:{port}", "--num_processes", str(ranks),
                                     "--process_id", str(r)],
                     "report": str(rep / f"rank{r}{ext}"), "payload": payload}
                    for (name, argv, payload), (out, rep, ext, port) in zip(jobs, dirs)]}
                env = dict(os.environ, LOCAL_WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                           **launch.AGENT_STORE_ENV)
                cmd = [sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
                       json.dumps(spec)]
                log = Path(f"{logs}_rank{r}.log")
                with open(log, "wb") as fh:
                    self.procs.append((k, r, log, subprocess.Popen(
                        dying_with_us(cmd), cwd=REPO, env=env, stdout=fh,
                        stderr=subprocess.STDOUT, start_new_session=True)))

    def wait(self) -> dict:
        import os
        import signal

        names = [[j[0] for j in jobs] for _, jobs in self.sets]
        deadline = time.time() + PAR_TIMEOUT * max(len(jobs) for _, jobs in self.sets)
        try:
            # Until every process has ended, or one has failed (the rest are
            # then killed below).
            while any(p.poll() is None for *_, p in self.procs) and \
                    not any(p.poll() for *_, p in self.procs):
                if time.time() > deadline:
                    k, r = next((k, r) for k, r, _, p in self.procs if p.poll() is None)
                    fail(f"{names[k]}: rank {r} did not finish in time")
                time.sleep(0.2)
        finally:
            for _, _, _, p in self.procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
            self.stores.clear()         # every rank has ended
        texts = [log.read_text(errors="replace") for _, _, log, _ in self.procs]
        # The first rank that failed by itself (the others were then killed).
        failed = sorted(((p.returncode == -signal.SIGKILL, i) for i, (*_, p)
                         in enumerate(self.procs) if p.returncode != 0))
        if failed:
            k, r, log, p = self.procs[failed[0][1]]
            print(texts[failed[0][1]][-4000:])
            fail(f"{names[k]}: rank {r} exited with code {p.returncode} (log {log})")
        for (k, r, _, _), text in zip(self.procs, texts):
            for line in text.splitlines():
                if line.startswith("job_peak_gib "):
                    print(f"  rank {r}: {line}")
                elif r == 0 and line.startswith("torch.distributed:"):
                    print(f"  rank 0: {line}")
                elif r == 0 and line.startswith("job_seconds ") and CLOCK is not None:
                    for job, sec in json.loads(line.split(" ", 1)[1]).items():
                        CLOCK.add(f"rank job {job} (set {k}: {len(names[k])} job(s) on "
                                  f"{self.sets[k][0]} rank(s))", sec)
        if CLOCK is not None:
            CLOCK.add(f"rank sets {' | '.join(', '.join(n) for n in names)}",
                      time.perf_counter() - self.t0)
        return {name: (rep / f"rank0{ext}" if payload else
                       [json.loads((rep / f"rank{r}{ext}").read_text()) for r in range(ranks)],
                       out)
                for name, (ranks, payload, (out, rep, ext, _)) in self.jobs.items()}


def par_one(name, argv, root, within=None):
    """``argv`` for PAR_EPOCHS epochs on one rank in this process: (the
    Trainer, its launches and the shapes K2-K6 took, as ``par_taken``
    records them, ms per D step of the last epoch). ``within(builder)``, a
    context, is entered around the run."""
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.training.loop import Trainer

    out = root / name.replace(" ", "_").replace(",", "")
    tr = Trainer(toptions.parse(argv + ["-ne", str(PAR_EPOCHS), "--manual_seed", "1",
                                        "-o", str(out)]))
    counts, seen = {}, set()
    with within(tr.builder) if within else contextlib.nullcontext(), par_taken(counts, seen):
        tr.run()
    if not _finite(tr.state):
        fail(f"{name}: non-finite state")
    return tr, counts, _last_epoch_ms(tr), seen


def saved_state(out, template):
    """The state of a run's last saves (the single-device format)."""
    from csl_gan_tpu_torch.training import checkpoint
    st, _ = checkpoint.load_g(str(out / "saves" / f"G-{PAR_EPOCHS}"), template)
    return checkpoint.load_d(str(out / "saves" / f"D-{PAR_EPOCHS}"), st)[0]


def halved(seen):
    """The shapes a rank of PAR_RANKS takes where one rank took ``seen``."""
    return {(k, tuple((s[0] // PAR_RANKS,) + s[1:] for s in shapes), dt)
            for k, shapes, dt in seen}


@timed
def par_shapes_held(name, seen, want, dev, peak_bytes, tp=1):
    """The shapes the ranks gave K2-K6 (``seen``) must be ``want`` (the
    one-rank run's, each batch cut to a rank's rows, or under ``tp`` each
    channel count to a rank's); each is then held against its kernel's
    plain version at its bound: K2/K3 by ``conv_held`` (the tensor-core
    variant on bf16 operands, FFMA on fp32), K4/K5 by ``gn_held`` (32 / tp
    groups), K6 by ``k6_held`` (at the last model rank's counter base)."""
    import torch
    if seen != want:
        fail(f"{name}: the ranks gave K2-K6 {sorted(seen, key=str)}, expected "
             f"{sorted(want, key=str)}")
    g = torch.Generator(dev).manual_seed(48)
    convs = sorted({(shapes, dt) for k, shapes, dt in seen if k in ("K2", "K3")}, key=str)
    for ((b, h, _, cin), (_, ho, _, cout)), dt in convs:
        if ho != (h + 4 - 5) // 2 + 1:
            fail(f"{name}: K2/K3 at [{b}, {h}, {h}, {cin}] -> {ho} is not a 5x5 stride-2 conv")
        variant = "tc" if dt == torch.bfloat16 else "ffma"
        r2, r3, _, _ = conv_held(f"{name}: conv {h}x{h}x{cin}->{cout} (B {b})",
                                 *conv_operands(g, dev, b, h, cin, cout, dt), variant)
        print(f"  {name}: conv {h}x{h}x{cin}->{cout} {str(dt)[6:]} (B {b}, a rank's), "
              f"{variant}: K2 rel l2 {r2:.3e}, K3 rel l2 {r3:.3e} (bound {CONV_BOUND:g})")
    for ((b, hw, c),), dt in sorted({(shapes, dt) for k, shapes, dt in seen
                                     if k in ("K4", "K5")}, key=str):
        gn_held(*gn_operands(g, dev, b, hw, c, dt), groups=32 // tp)
    for ((b, *leaf),), dt in sorted({(shapes, dt) for k, shapes, dt in seen if k == "K6"},
                                    key=str):
        # K6 takes the leaf's per-sample gradients [b, *leaf] as [b, P].
        p = math.prod(leaf)
        k6_held(g, dev, b, p, f"{name}, a rank's rows, leaf {leaf}", peak_bytes,
                base=(tp - 1) * p, on_device=False)


def par_groups_held(name, got, ref, halves, witness, repeat):
    """``got`` against the one-rank ``ref`` group by group, each group
    within PAR_FACTOR x max(its ``witness``, its ``repeat``, PAR_FLOOR);
    its gap to ``halves`` (the witness's state) printed beside."""
    gaps, beside = _group_gaps(got, ref), _group_gaps(got, halves)
    bounds = {g: PAR_FACTOR * max(witness[g], repeat[g], PAR_FLOOR) for g in gaps}
    print(f"  {name} against one rank, by group: " + "; ".join(
        f"{g} {gaps[g]:.3e} (bound {bounds[g]:.3e}; witness {witness[g]:.3e}; against the "
        f"run in halves {beside[g]:.3e})" for g in gaps))
    over = [g for g in gaps if not gaps[g] <= bounds[g]]
    if over:
        fail(f"{name}: {over} leave the one-rank state beyond their bounds")


@contextlib.contextmanager
def pinned_cudnn():
    """Deterministic cuDNN without autotuning over the block (the rank
    processes of phases 13 and 14 set it for their lifetime)."""
    import torch
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = was


def parallel_phase(dev, out_root, smi, peak_bytes):
    """Phase 13, with deterministic cuDNN. Returns each run's launches by
    rank, for the kernels line, and the one-rank references of path 1 and
    the MNIST ghost route (``par_one``'s records), which phase 14 takes."""
    with pinned_cudnn():
        return _parallel_phase(dev, out_root, smi, peak_bytes)


def _parallel_phase(dev, out_root, smi, peak_bytes):
    import torch

    root = out_root / "parallel"
    launches = {}

    def held_ranks(name, reports, want, ms1):
        for r in reports:
            got = {k: r["launches"][k] for k in want}
            if got != want or not r["finite"] or r["backend"] != "gloo" or \
                    r["runner"] != "StepRunner":
                fail(f"{name}: rank {r['rank']} launches {got} (expected {want}), backend "
                     f"{r['backend']}, runner {r['runner']}, finite {r['finite']}")
        launches[name] = [r["launches"] for r in reports]
        print(f"{name} [{smi}]: {PAR_RANKS} ranks over gloo sharing the card, "
              f"{PAR_EPOCHS} epochs of {reports[0]['n']} D steps; launches by rank "
              + "; ".join(f"rank {r['rank']}: " + (", ".join(
                  f"{k} {v}" for k, v in r["launches"].items() if v) or "none")
                          for r in reports)
              + "; ms per D step (last epoch) by rank " + ", ".join(
                  f"{r['ms']:.3f}" for r in reports)
              + f" against one rank's {ms1:.3f}; wall s by rank "
              + ", ".join(f"{r['wall_s']:.2f}" for r in reports))
        return set().union(*(shapes_of(r["shapes"]) for r in reports))

    # The rank runs need nothing of this process: they start first, on sets
    # of their own (the CelebA flagship's flags replicated and --fsdp with
    # the MNIST ghost route; path 1; the MNIST flagship as one NCCL rank),
    # while this process makes their one-rank references and the step
    # checks' payloads.
    t_phase = time.perf_counter()
    fsdp_argv = PAR_CELEBA + ["--fsdp", "true"]
    cases = (("path 1", PAR_PATH1, PAR_PATH1),
             ("MNIST ghost", PAR_MNIST, PAR_MNIST + ["--pallas_epoch", "false"]))
    runs = RankSets([
        (PAR_RANKS, [("CelebA 2 ranks", PAR_CELEBA, None), ("CelebA 2 ranks fsdp", fsdp_argv, None),
                     ("MNIST ghost 2 ranks", PAR_MNIST, None)]),
        (PAR_RANKS, [("path 1 2 ranks", PAR_PATH1, None)]),
        (1, [("MNIST NCCL", SURF_MNIST, None)])], root)

    # (a) The CelebA flagship's flags cut to 10 D steps an epoch: one rank in
    # this process (twice, and in halves: the witness), then the ranks' step
    # check and runs, replicated and --fsdp.
    tr1, want, ms1, seen1 = par_one("CelebA one rank", PAR_CELEBA, root)
    n_d, n_g = tr1.state.d_count, tr1.state.g_count
    formula = dict(_celeba_expect(n_d, n_g), K1=0, K6=0, **{"K6 leaves": 0})
    if {k: want[k] for k in formula} != formula:
        fail(f"CelebA one rank: launches {want}, expected {formula}")
    again, _, _, _ = par_one("CelebA one rank again", PAR_CELEBA, root)
    repeat = _group_gaps(again.state, tr1.state)
    del again
    halves, _, _, _ = par_one("CelebA one rank in halves", PAR_CELEBA, root, in_halves)
    witness = _group_gaps(halves.state, tr1.state)
    print(f"CelebA one rank [{smi}]: {PAR_EPOCHS} epochs of {tr1.n_batches} D steps, launches "
          f"{want}; {ms1:.3f} ms per D step (last epoch); witness, the one-rank run with "
          f"every pass in {PAR_RANKS} halves, by group: "
          + ", ".join(f"{g} {v:.3e}" for g, v in witness.items())
          + f"; two one-rank runs {max(repeat.values()):.3e}")

    # One full-width D step and G step (B 128, 64 rows a rank) from the
    # one-rank run's end state, replicated and under --fsdp, against the
    # same steps on one rank, each group within 3x the same steps in halves.
    b, st = tr1.builder, tr1.state
    runner, gs = tr1.step_runner, torch.Generator(dev).manual_seed(47)
    x, y = runner._batch(torch.randperm(runner.n_rows, generator=gs, device=dev)[:CB], gs)
    d_in = dict(x=x, y=y, use_dp=True, **runner._d_draws(st, x, y, gs, runner.noise_stds(st),
                                                         True))
    g_in = (b.gen_z(gs, CB), b.gen_y(gs, CB))
    payload = root / "step_payload.pt"
    torch.save({"state": st, "d": d_in, "g": g_in}, payload)
    # The G step alone from the one-rank D step's state, on the ranks and in
    # halves: bitwise equal (the whole step's gap to the step in halves in
    # G's groups is D's ~1e-8 carried through the bf16 G step, not G's own).
    st_d = b.d_core(st, **d_in)[0]
    g_payload = root / "g_step_payload.pt"
    torch.save({"state": st_d, "g": g_in}, g_payload)
    steps = RankSets([(PAR_RANKS, [("CelebA step", PAR_CELEBA, str(payload)),
                                   ("CelebA G step", PAR_CELEBA, str(g_payload))])], root)

    def one_step():
        return b.g_core(b.d_core(st, **d_in)[0], *g_in)[0]

    ref1, ref2 = one_step(), one_step()
    with in_halves(b):
        split = one_step()
    step_repeat, step_witness = _group_gaps(ref2, ref1), _group_gaps(split, ref1)
    g_ref = b.g_core(st_d, *g_in)[0]
    with in_halves(b):
        g_split = b.g_core(st_d, *g_in)[0]

    # (b)'s and (c)'s one-rank references: path 1 (K6 at [600, 101632]) and
    # the MNIST flagship's flags on the ghost route (K1 is the one-device
    # path) on the step runner, and the plain MNIST flagship on K1.
    ones = {}
    for name, argv, argv1 in cases:
        tr_1, want_1, ms_1, seen_1 = ones[name] = par_one(name + " one rank", argv1, root)
        if type(tr_1.runner).__name__ != "StepRunner" or want_1["K1"] or \
                want_1["K6"] != want_1["K6 leaves"] or \
                want_1["K6"] != (tr_1.state.d_count if argv is PAR_PATH1 else 0):
            fail(f"{name} one rank: launches {want_1} on the {type(tr_1.runner).__name__}")
    plain, want_plain, ms_plain, _ = par_one("MNIST plain", SURF_MNIST, root)

    got_steps = steps.wait()
    g_got = torch.load(got_steps["CelebA G step"][0], map_location=dev,
                       weights_only=False)[False]["state"]
    g_gaps, g_beside = _group_gaps(g_got, g_ref), _group_gaps(g_got, g_split)
    by_leaf = sorted(((rel_l2(g_got.g_mu[k].float(), g_split.g_mu[k].float()), k)
                      for k in g_split.g_mu), reverse=True)
    print(f"CelebA G step alone [{smi}] from one D-updated state, {PAR_RANKS} ranks: against "
          f"one rank, by group, " + ", ".join(f"{g} {v:.3e}" for g, v in g_gaps.items() if
                                             g.startswith("g_"))
          + "; against the G step in halves " + ", ".join(
              f"{g} {v:.3e}" for g, v in g_beside.items() if g.startswith("g_"))
          + "; g_mu (the gradient: b1 = 0) against the halves' by leaf, largest: " + ", ".join(
              f"{k} {v:.3e}" for v, k in by_leaf[:6]))
    if any(g_beside[g] != 0.0 for g in ("g_params", "g_mu", "g_nu")):
        fail("CelebA G step alone: the ranks' G step is not the G step in halves, bit for bit")
    del g_got, g_ref, g_split, st_d
    got = torch.load(got_steps["CelebA step"][0], map_location=dev, weights_only=False)
    celeba_seen = set(got["shapes"])
    for fsdp in (False, True):
        k = got[fsdp]["launches"]
        name = f"CelebA step{' fsdp' if fsdp else ''}"
        print(f"{name} [{smi}]: one D step and one G step at B {CB}, {CB // PAR_RANKS} rows a "
              f"rank on {PAR_RANKS} ranks; rank 0 launched K2 {k['K2']}, K3 {k['K3']}, K4 "
              f"{k['K4']}, K5 {k['K5']}; two one-rank steps {max(step_repeat.values()):.3e}")
        par_groups_held(name, got[fsdp]["state"], ref1, split, step_witness, step_repeat)
        if (k["K2"], k["K3"], k["K4"], k["K5"]) != (3, 3, 2 * G_NORMS, G_NORMS):
            fail(f"{name}: launches {k}")
    del ref1, ref2, split, got

    got_runs = runs.wait()
    whole_mb = _state_mb(tr1.state)
    state_mb = {}
    for fsdp in (False, True):
        name = "CelebA 2 ranks" + (" fsdp" if fsdp else "")
        reports, out = got_runs[name]
        celeba_seen |= held_ranks(name, reports, want, ms1)
        if any(r["fsdp"] != fsdp or r["counts"] != [n_d, n_g] for r in reports):
            fail(f"{name}: --fsdp / update counts {[(r['fsdp'], r['counts']) for r in reports]}")
        state_mb[fsdp] = [r["state_bytes"] / 2 ** 20 for r in reports]
        print(f"  state (params and Adam moments) by rank "
              + ", ".join(f"{x:.2f} MB ({x / whole_mb:.3f} of one rank's)"
                          for x in state_mb[fsdp])
              + "; torch.cuda.memory_allocated by rank at the run's end, over its start "
              + ", ".join(f"{r['allocated'] / 2 ** 20:.1f} MB" for r in reports))
        par_groups_held(name, saved_state(out, tr1.state), tr1.state, halves.state, witness,
                        repeat)
    if not all(x < 0.6 * whole_mb for x in state_mb[True]):
        fail(f"--fsdp: a rank holds {state_mb[True]} MB of a {whole_mb:.2f} MB state")
    del tr1, halves
    torch.cuda.empty_cache()
    par_shapes_held("CelebA 2 ranks", celeba_seen, halved(seen1), dev, peak_bytes)

    # (b) MNIST path 1 (K6 at [300, 101632] a rank, the noise from rank 0)
    # and the MNIST flagship's flags on the ghost route, each against its
    # one-rank run on the step runner.
    for name, _, _ in cases:
        tr_1, want_1, ms_1, seen_1 = ones[name]
        reports, out = got_runs[name + " 2 ranks"]
        seen = held_ranks(name + " 2 ranks", reports, want_1, ms_1)
        gap = _state_gap(saved_state(out, tr_1.state), tr_1.state)
        print(f"  end state against the one-rank run's (fp32): {gap:.3e} (bound "
              f"{PAR_FP32_BOUND:g})")
        if not gap <= PAR_FP32_BOUND:
            fail(f"{name}: 2 ranks leave the one-rank run by {gap:.3e}")
        par_shapes_held(name + " 2 ranks", seen, halved(seen_1), dev, peak_bytes)

    # (c) One rank on NCCL: the MNIST flagship's K1 path through --multihost
    # against the plain run, byte for byte.
    [r], out = got_runs["MNIST NCCL"]
    launches["MNIST NCCL"] = [r["launches"]]
    if r["backend"] != "nccl" or r["launches"] != want_plain or want_plain["K1"] != PAR_EPOCHS \
            or r["runner"] != "EpochsRunner":
        fail(f"MNIST NCCL: backend {r['backend']}, launches {r['launches']} (plain "
             f"{want_plain}), runner {r['runner']}")
    plain_saves = root / "MNIST_plain" / "saves"
    names = sorted(p.name for p in plain_saves.iterdir())
    same = names == sorted(p.name for p in (out / "saves").iterdir()) and all(
        (out / "saves" / f).read_bytes() == (plain_saves / f).read_bytes() for f in names)
    print(f"MNIST NCCL [{smi}]: one --multihost rank over nccl, K1 {r['launches']['K1']} "
          f"launch(es) on the {r['runner']}; saves {names} byte for byte the plain run's: "
          f"{same}; {r['ms']:.3f} ms per D step (last epoch) against the plain run's "
          f"{ms_plain:.3f}")
    if not same:
        fail("MNIST NCCL: the saves differ from the plain run's")
    del plain
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches, ones


# Phase 14: the tensor axis (--tp) on the card's machine, which shows one
# card: as in phase 13, --multihost ranks share it over gloo and pin
# deterministic cuDNN. At --tp 2 on 2 ranks (dp 1) each rank holds half the
# output channels of every leaf that the JAX rule shards and computes only
# those; 4 ranks make dp 2 x tp 2. Every run is PAR_EPOCHS epochs; the
# CelebA flagship's flags are cut to -tss 640 (5 D steps, one G update an
# epoch: at --tp 2 a D step takes seconds on the shared card).
TP = 2
TP_CELEBA1 = PAR_CELEBA[:PAR_CELEBA.index("-tss")] + ["-tss", "640"] \
    + PAR_CELEBA[PAR_CELEBA.index("-tss") + 2:]
TP_CELEBA = TP_CELEBA1 + ["--tp", str(TP)]
TP_PATH1 = PAR_PATH1 + ["--tp", str(TP)]
TP_MNIST = PAR_MNIST + ["--pallas_epoch", "false"]     # the fp32 ghost route, off K1
# (d) The D-step engines beside gc's routes at --tp 2: one full-width D step
# and G step each, from the one-rank CelebA or MNIST state of (a) / (b), with
# the launches each kernel must make in it (the one-rank step's and each
# rank's). The CelebA steps are bf16, each held to 3x its channel-halves
# witness; the MNIST ones fp32, held to PAR_FP32_BOUND.
TP_ENGINE_STEPS = (
    ("CelebA tm", PAR_CELEBA + ["-dpm", "tm"], {"K4": 2 * G_NORMS, "K5": G_NORMS}),
    ("CelebA Poisson", PAR_CELEBA + ["--poisson", "true"],
     {"K2": 3, "K3": 3, "K4": 2 * G_NORMS, "K5": G_NORMS}),
    ("CelebA adaptive", PAR_CELEBA + ["-gcm", "adaptive"],
     {"K2": 6, "K3": 3, "K4": 2 * G_NORMS, "K5": G_NORMS}),
    ("CelebA -pupd false", PUBLIC_CELEBA + ["-pupd", "false", "--pallas", "true"],
     {"K6": 1, "K6 leaves": 4, "K4": 2 * G_NORMS, "K5": G_NORMS}),
    ("CelebA DRAGAN", PAR_CELEBA + ["--penalty", "DRAGAN"],
     {"K2": 3, "K3": 3, "K4": 2 * G_NORMS, "K5": G_NORMS}),
    ("MNIST is", TP_MNIST + ["-dpm", "is"], {}),
    ("MNIST is per-param", TP_MNIST + ["-dpm", "is", "-ispp", "true"], {}),
    ("MNIST sv", TP_MNIST + ["-dpm", "sv"], {}),
    ("MNIST bpc", TP_MNIST + ["--backprop_clip", "true", "--pallas", "true"],
     {"K6": 1, "K6 leaves": 1}),
)
# Two engines through the Trainer at --tp 2 beside one rank's: CelebA Poisson (K2/K3 at the 219-row buffer on half the
# output channels; 5 D steps, as TP_CELEBA1: a D step at --tp 2 takes ~4 s)
# and path 1 with adaptive clipping (K6 at each slice's counter base with
# the step's adaptive std), fp32, its end state held to PAR_FP32_BOUND.
TP_ENGINE_RUNS = (
    ("CelebA Poisson", TP_CELEBA1 + ["--poisson", "true"]),
    ("path 1 adaptive", PAR_PATH1 + ["-gcm", "adaptive", "-nms", "1", "--mean_sample_size",
                                     "10"]),
)
TP_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K6 leaves")
# The ranks' step checks of phase 14 on three sets of 2 ranks at once, each
# set's jobs in turn, about even (rank 0's seconds a job on an NVIDIA H100
# 80GB HBM3 with the jobs in turn: CelebA tp step 26, Poisson 17, tm 14,
# adaptive 11, -pupd false 10, DRAGAN 10; each MNIST one 2-3).
TP_STEP_SETS = (("CelebA tp step", "CelebA DRAGAN tp step", "MNIST is tp step"),
                ("CelebA Poisson tp step", "CelebA tm tp step", "MNIST is per-param tp step"),
                ("CelebA adaptive tp step", "CelebA -pupd false tp step", "MNIST sv tp step",
                 "MNIST bpc tp step"))


def _tp_cut(w) -> bool:
    """Whether --tp 2 cuts a conv weight [O, I, kh, kw] or a dense weight
    [O, I]: its flax last dim O divisible and 2^11 elements or more (the
    JAX package's state_spec)."""
    return w.dim() in (2, 4) and w.shape[0] % TP == 0 and w.numel() >= 2 ** 11


@contextlib.contextmanager
def in_channel_halves():
    """The one-device step computing every layer that --tp 2 cuts in its TP
    parts of output channels, as the ranks split them: the convs and dense
    layers of the forwards, concatenated (their backwards through autograd,
    where the parts' input gradients add), each GroupNorm+ReLU on its
    parts' channels with 32 / TP groups, and in the conv-ghost real pass the
    input cotangents and K2's squared norms as the parts' fp32 sums and K3's
    sum concatenated. Nothing of ``parallel/`` takes part: the witness of
    what splitting the channels does to the arithmetic alone."""
    import torch
    from csl_gan_tpu_torch.models import dcresnet
    from csl_gan_tpu_torch.ops import conv_ghost
    from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
    conv, dense, gnr = dcresnet.conv_nhwc, dcresnet.dense, dcresnet.group_norm_relu
    cin, norms, wsum = torch.nn.grad.conv2d_input, pcg.ghost_sq_norms, pcg.weighted_kernel_grad

    def parts(w, b):
        return zip(w.chunk(TP), [None] * TP if b is None else b.chunk(TP))

    def conv_h(x, w, b, stride, padding, dtype=None):
        if not _tp_cut(w):
            return conv(x, w, b, stride, padding, dtype)
        return torch.cat([conv(x, wi, bi, stride, padding, dtype) for wi, bi in parts(w, b)],
                         dim=-1)

    def dense_h(x, w, b, dtype=None):
        if not _tp_cut(w):
            return dense(x, w, b, dtype)
        return torch.cat([dense(x, wi, bi, dtype) for wi, bi in parts(w, b)], dim=-1)

    def gnr_h(x, sc, bi, groups=32, eps=1e-5):
        if groups % TP or x.shape[-1] % TP:
            return gnr(x, sc, bi, groups, eps)
        return torch.cat([gnr(xi, si, bj, groups // TP, eps) for xi, si, bj in
                          zip(x.chunk(TP, -1), sc.chunk(TP), bi.chunk(TP))], dim=-1)

    def cin_h(shape, w, c, stride=1, padding=0):
        if not _tp_cut(w):
            return cin(shape, w, c, stride, padding)
        outs = [cin(shape, wi, ci, stride, padding) for wi, ci in zip(w.chunk(TP), c.chunk(TP, 1))]
        return sum(o.float() for o in outs).to(outs[0].dtype)

    def norms_h(a, c, kh, kw, stride, pad):
        return sum(norms(a, ci.contiguous(), kh, kw, stride, pad) for ci in c.chunk(TP, -1))

    def wsum_h(a, c, f, ks, stride, pad):
        part = tuple(ks[:3]) + (ks[3] // TP,)
        return torch.cat([wsum(a, ci.contiguous(), f, part, stride, pad)
                          for ci in c.chunk(TP, -1)], dim=-1)

    # The wrappers count their launches through their module names.
    norms_h.launches = norms_h.launches_tc = wsum_h.launches = wsum_h.launches_tc = 0
    with _swapped(((dcresnet, "conv_nhwc", conv_h), (conv_ghost, "conv_nhwc", conv_h),
                   (dcresnet, "dense", dense_h), (conv_ghost, "dense", dense_h),
                   (dcresnet, "group_norm_relu", gnr_h), (torch.nn.grad, "conv2d_input", cin_h),
                   (pcg, "ghost_sq_norms", norms_h), (pcg, "weighted_kernel_grad", wsum_h))):
        yield


def tp_halved(seen):
    """The shapes a rank of --tp 2 on 2 ranks gives K2-K6 where one rank gave
    ``seen``: every row of the batch, each conv's output channels, each
    norm's channels and each K6 leaf's dim 0 cut by TP."""
    out = set()
    for k, shapes, dt in seen:
        if k in ("K2", "K3"):
            a, c = shapes
            shapes = (a, c[:3] + (c[3] // TP,))
        elif k in ("K4", "K5"):
            (b, hw, c), = shapes
            shapes = ((b, hw, c // TP),)
        else:
            (b, o, *rest), = shapes
            shapes = ((b, o // TP, *rest),)
        out.add((k, shapes, dt))
    return out


def _k_counts(counts):
    """Each wrapper's launches of a ``par_counted`` record (K1-K6, and K6's
    leaves)."""
    return {k: counts[k] for k in TP_KERNELS}


@timed
def tp_engine_step(name, argv, expect, state, root, dev):
    """The one-rank side of one engine's step check (phase 14 (d)): a
    Trainer of ``argv`` for its draws (built, not trained), one full-width
    batch (a Poisson draw under --poisson) and its draws, then the D and G
    steps from ``state`` (its clipping and is scaling the engine's own) on
    one rank: counted and recorded, again (the repeat), the D step timed,
    and for bf16 in channel halves (the witness). Fails unless the one-rank
    step launches ``expect`` (every other kernel 0). Returns what the check
    of the ranks' step needs, the payload written under ``root``."""
    import dataclasses

    import torch
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.training.loop import Trainer

    tag = name.replace(" ", "_").replace("-", "")
    tr = Trainer(toptions.parse(argv + ["-ne", "1", "--manual_seed", "1", "-o",
                                        str(root / tag)]))
    b, runner = tr.builder, tr.step_runner
    state = dataclasses.replace(state, clipping=tr.state.clipping,
                                scaling_vec=tr.state.scaling_vec)
    gs = torch.Generator(dev).manual_seed(53)
    bs, valid = b.opt.batch_size, None
    if b.poisson:
        idx, valid = b.poisson_draw(gs, runner.n_rows)
    else:
        idx = torch.randperm(runner.n_rows, generator=gs, device=dev)[:bs]
    x, y = runner._batch(idx, gs)
    d_in = dict(x=x, y=y, use_dp=True, valid=valid,
                **runner._d_draws(state, x, y, gs, runner.noise_stds(state), True))
    g_in = (b.gen_z(gs, bs), b.gen_y(gs, bs))
    payload = root / f"{tag}_payload.pt"
    torch.save({"state": state, "d": d_in, "g": g_in}, payload)

    def one_step():
        return b.g_core(b.d_core(state, **d_in)[0], *g_in)[0]

    counts, seen = {}, set()
    with par_taken(counts, seen):
        ref1 = one_step()
    want = dict(dict.fromkeys(TP_KERNELS, 0), **expect)
    if _k_counts(counts) != want:
        fail(f"{name} one rank: launches {_k_counts(counts)}, expected {want}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.d_core(state, **d_in)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    ref2 = one_step()
    out = dict(name=name, argv=argv, payload=str(payload), ref=ref1, want=want, seen=seen,
               ms1=ms1, repeat=_group_gaps(ref2, ref1), bf16=b.compute_dtype is not None,
               batch=int(x.shape[0]))
    if out["bf16"]:
        with in_channel_halves():
            out["split"] = one_step()
        out["witness"] = _group_gaps(out["split"], ref1)
    del tr, ref2
    return out


def tp_engine_held(e, got, smi):
    """The ranks' step of one engine (rank 0's ``parallel_step_rank``
    record ``got``) against its one-rank step ``e``: the launches, then the
    state by group (bf16: 3x the channel-halves witness; fp32:
    PAR_FP32_BOUND). Returns rank 0's launches."""
    k = got["launches"]
    print(f"{e['name']} tp step [{smi}]: one D step and one G step at B {e['batch']} on {TP} "
          f"ranks at --tp {TP}; rank 0 launched " + (", ".join(
              f"{n} {v}" for n, v in _k_counts(k).items() if v) or "no kernel")
          + f"; D step {got['d_ms']:.1f} ms at --tp {TP} against one rank's {e['ms1']:.1f} "
          f"({got['d_ms'] / e['ms1']:.1f}x; host clock, one step); two one-rank steps "
          f"{max(e['repeat'].values()):.3e}")
    if _k_counts(k) != e["want"]:
        fail(f"{e['name']} tp step: rank 0 launches {_k_counts(k)}, expected {e['want']}")
    if e["bf16"]:
        par_groups_held(e["name"] + " tp step", got["state"], e["ref"], e["split"],
                        e["witness"], e["repeat"])
    else:
        gaps = _group_gaps(got["state"], e["ref"])
        print(f"  {e['name']} tp step against one rank, by group (fp32): "
              + ", ".join(f"{g} {v:.3e}" for g, v in gaps.items())
              + f" (bound {PAR_FP32_BOUND:g})")
        if not all(v <= PAR_FP32_BOUND for v in gaps.values()):
            fail(f"{e['name']} tp step: the ranks leave the one-rank step beyond the bound")
    return k


def tp_runs(out_root) -> RankSets:
    """Phase 14's rank runs at --tp 2, which need nothing of the process
    that starts them, on two sets at once ((c): the CelebA flagship's flags
    and path 1; (d): the engine runs)."""
    return RankSets([
        (TP, [("CelebA tp 2 ranks", TP_CELEBA, None), ("path 1 tp 2 ranks", TP_PATH1, None)]),
        (TP, [(name + " tp 2 ranks", argv + ["--tp", str(TP)], None)
              for name, argv in TP_ENGINE_RUNS])], out_root / "tp")


def tp_phase(dev, out_root, smi, peak_bytes, ones=None, runs=None):
    """Phase 14, with deterministic cuDNN. ``ones``: phase 13's one-rank
    references of path 1 and the MNIST ghost route, the same runs (made here
    when phase 14 runs alone); ``runs``: its rank runs (``tp_runs``), started
    before it (here when it runs alone). Returns each run's launches by rank
    and the engines' (d), for the kernels line."""
    with pinned_cudnn():
        return _tp_phase(dev, out_root, smi, peak_bytes, ones, runs or tp_runs(out_root))


def _tp_phase(dev, out_root, smi, peak_bytes, ones, runs):
    import torch

    root = out_root / "tp"
    launches = {}
    t_phase = time.perf_counter()

    def held_ranks(name, reports, want, ms1, mb1):
        # Each wrapper's launches; K4/K5's CUDA launches a call follow the
        # plan of the rank's channel count, which differs from one rank's.
        want = {k: v for k, v in want.items() if "cuda" not in k}
        for r in reports:
            got = {k: r["launches"][k] for k in want}
            if got != want or not r["finite"] or r["backend"] != "gloo" or \
                    r["runner"] != "StepRunner":
                fail(f"{name}: rank {r['rank']} launches {got} (expected {want}), backend "
                     f"{r['backend']}, runner {r['runner']}, finite {r['finite']}")
        launches[name] = [r["launches"] for r in reports]
        mb = [r["state_bytes"] / 2 ** 20 for r in reports]
        print(f"{name} [{smi}]: {len(reports)} ranks at --tp {TP} over gloo sharing the card, "
              f"{PAR_EPOCHS} epoch(s) of {reports[0]['n']} D steps; launches by rank "
              + "; ".join(f"rank {r['rank']}: " + (", ".join(
                  f"{k} {v}" for k, v in r["launches"].items() if v) or "none")
                          for r in reports)
              + "; ms per D step (last epoch) by rank " + ", ".join(
                  f"{r['ms']:.3f}" for r in reports)
              + f" against one rank's {ms1:.3f}; wall s by rank "
              + ", ".join(f"{r['wall_s']:.2f}" for r in reports)
              + "; state (params and Adam moments) MB by rank " + ", ".join(
                  f"{x:.2f} ({x / mb1:.3f} of one rank's {mb1:.2f})" for x in mb))
        if any(r["counts"] != reports[0]["counts"] for r in reports):
            fail(f"{name}: update counts {[r['counts'] for r in reports]}")
        return set().union(*(shapes_of(r["shapes"]) for r in reports)), mb

    # The rank runs at --tp 2 (``runs``) went first; this process makes the
    # one-rank side meanwhile.
    # (a) The CelebA flagship's flags cut to 10 D steps an epoch on one rank
    # (its end state starts the step check), one full-width D step and G
    # step from it at --tp 2 against the same steps on one rank, each group
    # within 3x the same steps computed in channel halves.
    tr1, want, ms1, seen1 = par_one("CelebA one rank", TP_CELEBA1, root)
    formula = dict(_celeba_expect(tr1.state.d_count, tr1.state.g_count), K1=0, K6=0,
                   **{"K6 leaves": 0})
    if {k: want[k] for k in formula} != formula:
        fail(f"CelebA one rank: launches {want}, expected {formula}")
    b, st = tr1.builder, tr1.state
    runner, gs = tr1.step_runner, torch.Generator(dev).manual_seed(47)
    x, y = runner._batch(torch.randperm(runner.n_rows, generator=gs, device=dev)[:CB], gs)
    d_in = dict(x=x, y=y, use_dp=True, **runner._d_draws(st, x, y, gs, runner.noise_stds(st),
                                                         True))
    g_in = (b.gen_z(gs, CB), b.gen_y(gs, CB))
    payload = root / "tp_step_payload.pt"
    torch.save({"state": st, "d": d_in, "g": g_in}, payload)

    def one_step():
        return b.g_core(b.d_core(st, **d_in)[0], *g_in)[0]

    ref1, ref2 = one_step(), one_step()
    with in_channel_halves():
        split = one_step()
    step_repeat, step_witness = _group_gaps(ref2, ref1), _group_gaps(split, ref1)
    mb1 = _state_mb(st)

    # (b) The fp32 runs' one-rank references, phase 13's where it ran in this
    # process: path 1 (K6) for an epoch, and the MNIST flagship's flags on the
    # ghost route, whose end state starts one D + G step.
    if ones is None:
        ones = {"path 1": par_one("path 1 one rank", PAR_PATH1, root),
                "MNIST ghost": par_one("MNIST ghost one rank", TP_MNIST, root)}
    p1, want_p1, ms_p1, seen_p1 = ones["path 1"]
    if want_p1["K6"] != p1.state.d_count or want_p1["K6 leaves"] != want_p1["K6"] or \
            want_p1["K1"]:
        fail(f"path 1 one rank: launches {want_p1}")
    mn = ones["MNIST ghost"][0]
    mb_, mst = mn.builder, mn.state
    mrun, gm = mn.step_runner, torch.Generator(dev).manual_seed(49)
    mx, my = mrun._batch(torch.randperm(mrun.n_rows, generator=gm, device=dev)[:BS], gm)
    md_in = dict(x=mx, y=my, use_dp=True, **mrun._d_draws(mst, mx, my, gm,
                                                         mrun.noise_stds(mst), True))
    mg_in = (mb_.gen_z(gm, BS), mb_.gen_y(gm, BS))
    mpayload = root / "tp_mnist_payload.pt"
    torch.save({"state": mst, "d": md_in, "g": mg_in}, mpayload)
    mref = mb_.g_core(mb_.d_core(mst, **md_in)[0], *mg_in)[0]

    # (d) The engines' one-rank steps from the CelebA and MNIST states, and
    # their one-rank Trainer runs.
    engines = {name: tp_engine_step(name, argv, expect, st if argv[0] == "CelebA" else mst,
                                    root, dev) for name, argv, expect in TP_ENGINE_STEPS}
    # The ranks' step checks on three sets and the dp 2 x tp 2 step on four
    # ranks, at once (TP_STEP_SETS); the engine runs' references meanwhile.
    step = {"CelebA tp step": (TP_CELEBA, str(payload))}
    step.update({e["name"] + " tp step": (e["argv"] + ["--tp", str(TP)], e["payload"])
                 for e in engines.values()})
    steps = RankSets([(TP, [(n, *step[n]) for n in names]) for names in TP_STEP_SETS]
                     + [(2 * TP, [("MNIST tp step dp2", TP_MNIST + ["--tp", str(TP)],
                                   str(mpayload))])], root)
    engine_ones = [par_one(name + " one rank", argv, root) for name, argv in TP_ENGINE_RUNS]
    got_steps = steps.wait()

    got = torch.load(got_steps["CelebA tp step"][0], map_location=dev, weights_only=False)
    k = got[False]["launches"]
    print(f"CelebA tp step [{smi}]: one D step and one G step at B {CB} on {TP} ranks at --tp "
          f"{TP} (every row, half the channels a rank); rank 0 launched K2 {k['K2']}, K3 "
          f"{k['K3']}, K4 {k['K4']}, K5 {k['K5']}; two one-rank steps "
          f"{max(step_repeat.values()):.3e}")
    par_groups_held("CelebA tp step", got[False]["state"], ref1, split, step_witness,
                    step_repeat)
    if (k["K2"], k["K3"], k["K4"], k["K5"]) != (3, 3, 2 * G_NORMS, G_NORMS):
        fail(f"CelebA tp step: launches {k}")
    launches["CelebA tp step"] = [k]
    seen = set(got["shapes"])
    mgot = torch.load(got_steps["MNIST tp step dp2"][0], map_location=dev, weights_only=False)
    mgaps = _group_gaps(mgot[False]["state"], mref)
    print(f"MNIST tp step dp2 [{smi}]: one D step (ghost route, fp32) and one G step at B {BS} "
          f"on {2 * TP} ranks as (data, model) = (2, {TP}) against one rank, by group: "
          + ", ".join(f"{g} {v:.3e}" for g, v in mgaps.items())
          + f" (bound {PAR_FP32_BOUND:g}); rank 0 launched "
          + (", ".join(f"{n} {v}" for n, v in mgot[False]["launches"].items() if v) or "none"))
    if not all(v <= PAR_FP32_BOUND for v in mgaps.values()):
        fail("MNIST tp step dp2: the ranks leave the one-rank step beyond the bound")
    launches["MNIST tp step dp2"] = [mgot[False]["launches"]]
    del ref1, ref2, split, got, mgot

    # (c) An epoch through train.main on 2 ranks at --tp 2: the CelebA
    # flagship's flags and path 1's. The ranks' saves load as one rank's.
    got_runs = runs.wait()
    celeba, celeba_out = got_runs["CelebA tp 2 ranks"]
    cs, mb = held_ranks("CelebA tp 2 ranks", celeba, want, ms1, mb1)
    seen |= cs
    if not all(x < 0.6 * mb1 for x in mb):
        fail(f"--tp: a rank holds {mb} MB of a {mb1:.2f} MB state")
    saved = saved_state(celeba_out, tr1.state)
    print("  saves (rank 0's, whole leaves) load as one rank's; against the one-rank run, by "
          "group (bf16; no bound: the step check above carries the precision): " + ", ".join(
              f"{g} {v:.3e}" for g, v in _group_gaps(saved, tr1.state).items()))
    if not _finite(saved) or saved.d_count != tr1.state.d_count:
        fail("CelebA tp 2 ranks: the saves are not the run's")
    del tr1
    path1, path1_out = got_runs["path 1 tp 2 ranks"]
    ps, _ = held_ranks("path 1 tp 2 ranks", path1, want_p1, ms_p1, _state_mb(p1.state))
    gap = _state_gap(saved_state(path1_out, p1.state), p1.state)
    print(f"  end state (saves) against the one-rank run's (fp32, K6's noise at each slice's "
          f"counter base): {gap:.3e} (bound {PAR_FP32_BOUND:g})")
    if not gap <= PAR_FP32_BOUND:
        fail(f"path 1 tp 2 ranks: the ranks leave the one-rank run by {gap:.3e}")
    torch.cuda.empty_cache()
    par_shapes_held("CelebA tp", seen, tp_halved(seen1), dev, peak_bytes, tp=TP)
    par_shapes_held("path 1 tp", ps, tp_halved(seen_p1), dev, peak_bytes, tp=TP)
    held = seen | ps

    # (d) Each engine's step on the ranks against its one-rank step, then
    # the two engine runs; every K2-K6 shape they gave the ranks (each one
    # rank's with the channels cut) held against plain where (a)-(c) did
    # not hold it.
    engine_launches, new_seen, new_want = {}, set(), set()
    for name, _, _ in TP_ENGINE_STEPS:
        e = engines.pop(name)
        got = torch.load(got_steps[name + " tp step"][0], map_location=dev, weights_only=False)
        engine_launches[name + " tp step"] = [tp_engine_held(e, got[False], smi)]
        if set(got["shapes"]) != tp_halved(e["seen"]):
            fail(f"{name} tp step: the ranks gave K2-K6 {sorted(got['shapes'], key=str)}, "
                 f"expected {sorted(tp_halved(e['seen']), key=str)}")
        new_seen |= set(got["shapes"])
        new_want |= tp_halved(e["seen"])
        del got, e
    for (name, _), (tr_e, want_e, ms_e, seen_e) in zip(TP_ENGINE_RUNS, engine_ones):
        run = name + " tp 2 ranks"
        reports, out = got_runs[run]
        rs, _ = held_ranks(run, reports, want_e, ms_e, _state_mb(tr_e.state))
        engine_launches[run] = launches.pop(run)
        new_seen |= rs
        new_want |= tp_halved(seen_e)
        saved_e = saved_state(out, tr_e.state)
        gap = _state_gap(saved_e, tr_e.state)
        if tr_e.builder.compute_dtype is None:
            print(f"  end state (saves) against the one-rank run's (fp32): {gap:.3e} (bound "
                  f"{PAR_FP32_BOUND:g})")
            if not gap <= PAR_FP32_BOUND:
                fail(f"{run}: the ranks leave the one-rank run by {gap:.3e}")
        else:
            print(f"  end state (saves) against the one-rank run's (bf16; no bound: the step "
                  f"check carries the precision): {gap:.3e}")
        if not _finite(saved_e) or saved_e.d_count != tr_e.state.d_count:
            fail(f"{run}: the saves are not the run's")
    del engine_ones
    torch.cuda.empty_cache()
    par_shapes_held("tp engines", new_seen - held, new_want - held, dev, peak_bytes, tp=TP)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches, engine_launches


def _group_gaps(a, b) -> dict:
    """``_state_gap`` by group."""
    import torch
    return {g: rel_l2(torch.cat([getattr(a, g)[k].float().reshape(-1) for k in getattr(b, g)]),
                      torch.cat([getattr(b, g)[k].float().reshape(-1) for k in getattr(b, g)]))
            for g in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu")}


def _state_mb(st) -> float:
    return sum(t.numel() * t.element_size() for f in ("d_params", "d_mu", "d_nu", "g_params",
                                                      "g_mu", "g_nu")
               for t in getattr(st, f).values()) / 2 ** 20


def plan() -> list:
    """[(kind, label, argv)]: every configuration that a full run drives
    through a Trainer of its own processes ("Trainer"), a rank process
    ("rank run", "rank step") or the CLI, read from the tables its phases
    read. A full run fails unless it drove each one (``CLOCK.driven``), and
    tests/test_torch_smoke_plan.py holds the plan to the configurations the
    smoke drove before (``config_key`` says what counts)."""
    runs = []

    def add(kind, label, argv):
        runs.append((kind, label, list(argv)))

    add("Trainer", "MNIST flagship", MNIST_FLAGSHIP)
    add("Trainer", "MNIST --download_mnist", MNIST_FLAGSHIP + ["--download_mnist", "-d", "DIR"])
    add("Trainer", "CelebA flagship", FLAGSHIP)
    # 5: each flagship 2 epochs with a save every epoch, 1 epoch, then resumed.
    for label, argv in (("MNIST", SAVES_MNIST + ["--sample_every", "60000"]),
                        ("CelebA", SAVES_CELEBA)):
        add("Trainer", f"saves {label}, 2 epochs", argv + ["--save_every", "1"])
        add("Trainer", f"saves {label}, 1 epoch", argv)
        add("Trainer", f"{label} resumed", [label, "-rp", "DIR", "-re", "1", "-ka", "n_epochs"])
    add("CLI", "SIGTERM", SAVES_MNIST)
    add("Trainer", "path 1", PATH1)
    add("Trainer", "path 2", PATH2)
    for name, mode in DP_MNIST_MODES:
        add("Trainer", f"MNIST {name}", DP_MNIST + mode)
    for name, mode in DP_CELEBA_MODES:
        add("Trainer", f"CelebA {name}", DP_CELEBA + mode)
    for name, variant in COND_ARCHS:
        add("Trainer", f"CelebA {name}", COND_CELEBA + variant)
    for name, variant in COND_ARCHS[:3]:
        add("Trainer", f"MNIST {name}", COND_MNIST + variant)
    for name, argv in PUBLIC_RUNS:
        add("Trainer", name, argv)
    for name, argv, _ in SURFACE_RUNS:
        add("Trainer", name, argv)
    add("Trainer", "MNIST bpc bounds", SURFACE_RUNS[5][1] + ["--sigma", "0"])
    # 12
    for name, extra in (("flagship", []), ("-wd", ["-wd", "1e-4"]),
                        ("u8 table", ["--u8_table", "true"]), ("bf16", ["--bf16", "true"]),
                        ("sub-epoch cadence", ["--log_every", str(SURF_CADENCE),
                                               "--sample_every", str(SURF_CADENCE)])):
        add("Trainer", f"MNIST {name}", SURF_MNIST + extra)
    files = ["-d", "IMG", "-lp", "ATTR"]
    for name, extra in (("flagship", []), ("group_fakes", ["--group_fakes", "true"]),
                        ("cache", files), ("host loop", files + ["--host_loop", "true"]),
                        ("profile", ["-p"])):
        add("Trainer", f"CelebA {name}", SURF_CELEBA + extra)
    # 13 and 14: one rank in a smoke process, then the ranks.
    for name, argv in (("CelebA one rank", PAR_CELEBA), ("path 1 one rank", PAR_PATH1),
                       ("MNIST ghost one rank", TP_MNIST), ("MNIST plain", SURF_MNIST),
                       ("tp CelebA one rank", TP_CELEBA1)):
        add("Trainer", name, argv)
    for name, argv, _ in TP_ENGINE_STEPS:
        add("Trainer", f"{name} (its one-rank step's draws)", argv)
    for name, argv in TP_ENGINE_RUNS:
        add("Trainer", f"{name} one rank", argv)

    def ranks(kind, name, argv, n):
        add(kind, name, argv + ["--multihost", "true", "--num_processes", str(n)])

    for name, argv in (("CelebA step", PAR_CELEBA), ("CelebA tp step", TP_CELEBA),
                       *((f"{n} tp step", a + ["--tp", str(TP)]) for n, a, _ in TP_ENGINE_STEPS)):
        ranks("rank step", name, argv, PAR_RANKS)
    ranks("rank step", "MNIST tp step dp2", TP_MNIST + ["--tp", str(TP)], 2 * TP)
    for name, argv in (("CelebA 2 ranks", PAR_CELEBA),
                       ("CelebA 2 ranks fsdp", PAR_CELEBA + ["--fsdp", "true"]),
                       ("path 1 2 ranks", PAR_PATH1), ("MNIST ghost 2 ranks", PAR_MNIST),
                       ("CelebA tp 2 ranks", TP_CELEBA), ("path 1 tp 2 ranks", TP_PATH1),
                       *((f"{n} tp 2 ranks", a + ["--tp", str(TP)]) for n, a in TP_ENGINE_RUNS)):
        ranks("rank run", name, argv, PAR_RANKS)
    ranks("rank run", "MNIST NCCL", SURF_MNIST, 1)
    return runs


class SassDumps:
    """``cuobjdump -sass`` of K2/K3's and K1's libraries, started at once in
    the background; ``check()`` waits for them and fails unless K2/K3's
    holds warpgroup MMA (HGMMA) instructions and K1's no tensor-core
    instruction (its products are fp32 FFMA)."""

    LIBS = (("conv_ghost", True), ("k1_epoch", False))

    def __init__(self, build, out_root):
        out_root.mkdir(parents=True, exist_ok=True)
        self.tool = Path(build._nvcc()).with_name("cuobjdump")
        self.procs = {}
        if self.tool.exists():
            for lib, _ in self.LIBS:
                out = out_root / f"{lib}.sass"
                with open(out, "wb") as fh:
                    self.procs[lib] = (out, subprocess.Popen(
                        dying_with_us([self.tool, "-sass", build._target(lib)]), stdout=fh,
                        stderr=subprocess.PIPE))

    def check(self) -> None:
        for lib, want_mma in self.LIBS:
            if lib not in self.procs:
                print(f"cuobjdump -sass {lib}: not run (no {self.tool})")
                continue
            out, proc = self.procs[lib]
            err = proc.communicate()[1].decode(errors="replace")
            if proc.returncode != 0:
                print(f"cuobjdump -sass {lib}: not run ({err.strip()[:200]})")
                continue
            text = out.read_text(errors="replace")
            n_hgmma, n_hmma = text.count("HGMMA"), text.count("HMMA")
            print(f"cuobjdump -sass {lib}: {n_hgmma} HGMMA (wgmma), {n_hmma} HMMA (mma), "
                  f"{text.count('FFMA')} FFMA instructions")
            if want_mma and n_hgmma == 0:
                fail(f"no HGMMA instruction in the {lib} library")
            if not want_mma and n_hgmma + n_hmma > 0:
                fail(f"tensor-core instructions in the {lib} library")


# The standalone flags after the build, each with the one phase it runs
# (--dp-modes, --cond-archs and --clip build only what their phase needs).
ALONE = {"--gn-plans": "gn_plans", "--saves": "saves", "--public-data": "public_data",
         "--dp-surface": "dp_surface", "--interop": "interop", "--surface": "surface",
         "--parallel": "parallel", "--tp": "tp"}


# The phases that a full run gives a second smoke process on the same card
# (``--beside``), beside phases 6-10 and 12 in the first: 5 (saves), 11
# (interop), 13 and 14 (the ranks). Each needs nothing of the phases beside
# it and gives the kernels line only its launches.
BESIDE = ("saves", "interop", "parallel", "tp")


def beside_phases(dev, out_root, smi, peak_flops, peak_bytes) -> dict:
    """Phases 5, 11, 13 and 14 in turn (``--beside``): their launches for
    the kernels line."""
    # 5. Saves, resume, sample grids, SIGTERM and the evaluation tools.
    with CLOCK.phase("saves"):
        saves_phase(out_root, smi)
    # 11. Interop: a reference run converted, sampled, scored with Inception
    # FID and resumed.
    with CLOCK.phase("interop"):
        interop = interop_phase(dev, out_root, smi, peak_flops)
    # 13. Multi-device training: 2 ranks sharing the card over gloo (CelebA,
    # replicated and --fsdp; path 1; the MNIST ghost route), 1 rank on NCCL.
    # Phase 14's rank runs need nothing of this process: they start with
    # phase 13.
    with CLOCK.phase("parallel"):
        runs = tp_runs(out_root)
        par, ones = parallel_phase(dev, out_root, smi, peak_bytes)
    # 14. The tensor axis: --tp 2 on 2 ranks sharing the card (a CelebA
    # step against its channel-halves witness, the CelebA flagship's flags
    # and path 1 for an epoch), dp 2 x tp 2 on 4 ranks (an MNIST step); the
    # engines' steps and two engine runs.
    with CLOCK.phase("tp"):
        tp, tp_engines = tp_phase(dev, out_root, smi, peak_bytes, ones, runs)
    return {"interop": interop, "parallel": par, "tp": tp, "tp_engines": tp_engines}


class Beside:
    """BESIDE's phases in a second smoke process (``chip_smoke.py --beside
    RESULTS``), started at once; ``wait()`` prints its output, fails if it
    failed, folds its phase_seconds into this run's and returns its
    results."""

    def __init__(self, out_root):
        out_root.mkdir(parents=True, exist_ok=True)
        self.results, self.log = out_root / "beside.json", out_root / "beside.log"
        self.results.unlink(missing_ok=True)
        cmd = [sys.executable, "-u", str(Path(__file__).resolve()), "--beside",
               str(self.results)]
        with open(self.log, "wb") as fh:
            self.proc = subprocess.Popen(dying_with_us(cmd), cwd=REPO, stdout=fh,
                                         stderr=subprocess.STDOUT)

    def wait(self) -> dict:
        rc = self.proc.wait()
        print(f"--- phases {', '.join(BESIDE)}, run in a second process beside this one "
              f"(exit {rc}): its output ---")
        print(self.log.read_text(errors="replace").rstrip())
        print("--- the end of the second process's output ---", flush=True)
        if rc != 0:
            fail(f"the second process (phases {', '.join(BESIDE)}) exited with code {rc}")
        res = json.loads(self.results.read_text())
        ps = res.pop("phase_seconds")
        for name in BESIDE:
            CLOCK.phases[name] = ps["phases"][name]
            if name in ps["peak_gib"]:
                CLOCK.peak_gib[name] = ps["peak_gib"][name]
        CLOCK.items.update({k: v for k, v in ps["items"].items()
                            if k.split(":")[0] in BESIDE})
        CLOCK.second = {"phases": list(BESIDE), "total": ps["total"]}
        CLOCK.driven |= {(kind, tuple(map(tuple, key))) for kind, key in res.pop("driven")}
        return res


def main() -> int:
    global CLOCK
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (REPO / "csl_gan_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"no csl_gan_tpu_torch sources beside {__file__}")
    sys.path.insert(0, str(REPO))
    CLOCK = CLOCK or Clock()
    out_root = REPO / "build" / "chip_smoke"
    with trainers_timed(out_root), mnist_made_once():
        return run_phases(torch, out_root)


def print_phase_seconds() -> None:
    """The phase_seconds line, once a run (after its phases, or where it
    fails or is stopped)."""
    if CLOCK is not None and CLOCK.phases and not CLOCK.printed:
        CLOCK.printed = True
        print(json.dumps(CLOCK.line()), flush=True)


def run_phases(torch, out_root) -> int:
    # 1. The card.
    with CLOCK.phase("card"):
        smi = subprocess.run(dying_with_us(["nvidia-smi", "--query-gpu=name,power.limit",
                                            "--format=csv,noheader"]), capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[0]
        print(smi)
        kind = torch.cuda.get_device_name(0)
        peak_flops, peak_bf16, peak_bytes = next(
            ((f, h, b) for key, f, h, b in PEAKS if key in kind), PEAKS[-1][1:])
        # The plain versions are the fp32 reference: no TF32 in any product.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)

    from csl_gan_tpu_torch.ops import _build

    def build(names=_build.KERNELS):
        t0 = time.perf_counter()
        _build.build_all(names)
        for unit, sec in _build.build_seconds.items():
            CLOCK.add(f"nvcc {unit}", sec)
        print(f"build: {time.perf_counter() - t0:.1f} s for {len(names)} libraries, "
              f"{sum(len(_build.units(n)) for n in names)} translation units; nvcc by unit: "
              + (", ".join(f"{u} {sec:.1f} s" for u, sec in _build.build_seconds.items())
                 or "none (built before)"))

    if "--dp-modes" in sys.argv[1:]:
        with CLOCK.phase("build"):
            build(("gn_relu",))
        with CLOCK.phase("engines"):
            dp_modes_phase(dev, out_root, smi)
        print_phase_seconds()
        return 0
    if "--cond-archs" in sys.argv[1:]:
        with CLOCK.phase("build"):
            build(("conv_ghost", "gn_relu"))
        with CLOCK.phase("variants"):
            cond_archs_phase(dev, out_root, smi)
        print_phase_seconds()
        return 0
    if "--clip" in sys.argv[1:]:
        with CLOCK.phase("build"):
            build(("clip_noise",))
            for fn, report in ptxas_by_kernel(_build.build_logs.get("clip_noise", "")).items():
                print(f"ptxas clip_noise {fn}: {report}")
        with CLOCK.phase("k6_checks"):
            k6 = clip_kernel_phase(dev, peak_bytes, k6_large_leaves())
        print_phase_seconds()
        print(json.dumps({"k6": k6}))
        return 0

    if "--beside" in sys.argv[1:]:
        # The second process of a full run: the first one built every library.
        results = Path(sys.argv[sys.argv.index("--beside") + 1])
        with CLOCK.phase("build"):
            build()
        out = beside_phases(dev, out_root, smi, peak_flops, peak_bytes)
        results.write_text(json.dumps(dict(out, driven=sorted(CLOCK.driven), **CLOCK.line())))
        CLOCK.printed = True                # the first process prints it, merged
        return 0

    # 2. Build.
    with CLOCK.phase("build"):
        build()
        for name, log in _build.build_logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
        # The tensor-core kernels of K2 / K3 by name, and any ptxas advisory
        # (C75xx: e.g. wgmma serialised) of their source.
        for fn, report in ptxas_by_kernel(_build.build_logs.get("conv_ghost", "")).items():
            if any(k in fn for k in ("wsum_tc", "ghost_norm_tc", "scale_cotangent")):
                print(f"ptxas conv_ghost {fn}: {report}")
        for line in _build.build_logs.get("conv_ghost", "").splitlines():
            if "(C75" in line or "warning" in line:
                print(f"ptxas conv_ghost: {line.strip()}")
        # K2 / K3's tensor-core variants must hold warpgroup MMA instructions;
        # K1's products are fp32 FFMA and must hold no tensor-core instruction:
        # the SASS, dumped in the background (K1's took 17.7 s) and read
        # before the second process starts.
        sass = SassDumps(_build, out_root)

    alone = {"gn_plans": lambda: gn_plans_phase(dev),
             "saves": lambda: saves_phase(out_root, smi),
             "public_data": lambda: public_data_phase(dev, out_root, smi, peak_bf16,
                                                      peak_bytes),
             "dp_surface": lambda: dp_surface_phase(dev, out_root, smi),
             "interop": lambda: interop_phase(dev, out_root, smi, peak_flops),
             "surface": lambda: surface_phase(dev, out_root, smi, warm_up=True),
             "parallel": lambda: parallel_phase(dev, out_root, smi, peak_bytes),
             "tp": lambda: tp_phase(dev, out_root, smi, peak_bytes)}
    for flag, phase in ALONE.items():
        if flag in sys.argv[1:]:
            with CLOCK.phase("build"):
                sass.check()
            with CLOCK.phase(phase):
                out = alone[phase]()
            print_phase_seconds()
            if flag == "--tp":
                print(json.dumps({"tp_engine_launches": out[1]}))
            return 0

    # 6a. K6 against its plain version at every shape its paths give it,
    # timed on the device first: late in a long run a torch.profiler trace
    # of a short window has come back empty.
    with CLOCK.phase("k6_checks"):
        large = k6_large_leaves()
        k6_entry = clip_kernel_phase(dev, peak_bytes, large)

    # 3. The MNIST path (K1): kernel vs plain, the Trainer, the flagship on
    # downloaded files, K1's timing.
    with CLOCK.phase("mnist"):
        max_abs = k1_check_phase(dev, out_root)
        launches, k1_epoch_ms = mnist_path_phase(out_root)
        mnist_download_phase(out_root, smi)
        kernels = [k1_timing_phase(dev, out_root, peak_flops, peak_bytes, launches, max_abs)]

    # 4. The CelebA path (K2-K5).
    with CLOCK.phase("celeba"):
        celeba_entries, celeba_step_ms = celeba_phases(dev, out_root, peak_bf16, peak_bytes)
        kernels += celeba_entries

    with CLOCK.phase("build"):
        sass.check()

    # 5, 11, 13 and 14 in a second smoke process on the card, from here on,
    # beside 6-10 and 12 in this one (the kernels' times above are taken
    # with the card to themselves).
    beside = Beside(out_root)

    # 6. The materialized per-sample-gradient paths (K6).
    with CLOCK.phase("k6_paths"):
        kernels.append(clip_phases(dev, out_root, k6_entry, large, k1_epoch_ms,
                                   celeba_step_ms))

    # 7. The D-step engines beside gc (is, tm / sv, no DP).
    with CLOCK.phase("engines"):
        tm_launches = dp_modes_phase(dev, out_root, smi, celeba_step_ms)
    for entry in kernels:
        if entry["name"] in ("gn_relu_forward", "gn_relu_backward"):
            entry["celeba_tm_launches"] = tm_launches[entry["name"] == "gn_relu_backward"]

    # 8. The conditional variants (CGAN, WCGAN, unconditional, embedded G).
    with CLOCK.phase("variants"):
        cond = cond_archs_phase(dev, out_root, smi, k1_epoch_ms / (60000 // BS),
                                celeba_step_ms)
    keys = {"k1_epoch": "K1", "ghost_sq_norms": "K2", "weighted_kernel_grad": "K3",
            "gn_relu_forward": "K4", "gn_relu_backward": "K5",
            "leaves_weighted_sum_noise": "K6"}
    for entry in kernels:
        entry["cond_arch_launches"] = {path: counts[keys[entry["name"]]]
                                       for path, counts in cond.items()}

    # 9. Public data, warmup and adaptive clipping; every kernel at batch 50.
    with CLOCK.phase("public_data"):
        public, b50 = public_data_phase(dev, out_root, smi, peak_bf16, peak_bytes,
                                        k1_epoch_ms / (60000 // BS), celeba_step_ms)
    for entry in kernels:
        k = keys[entry["name"]]
        entry["public_data_launches"] = {run: counts[k] for run, counts in public.items()}
        if k in b50:
            entry["b50_ms"], entry["b50_plain_ms"] = b50[k]

    # 10. The rest of the DP surface: Poisson, the per-sample and DRAGAN
    # penalties, backprop clipping; K2-K5 at the Poisson buffer.
    with CLOCK.phase("dp_surface"):
        surface, cap_ms = dp_surface_phase(dev, out_root, smi, k1_epoch_ms / (60000 // BS),
                                           celeba_step_ms)
    for entry in kernels:
        k = keys[entry["name"]]
        entry["dp_surface_launches"] = {run: counts[k] for run, counts in surface.items()}
        if k in cap_ms:
            entry[f"b{CAP}_ms"], entry[f"b{CAP}_plain_ms"] = cap_ms[k]

    # 12. The rest of the single-device surface: -wd, --u8_table, --bf16 and
    # a sub-epoch cadence on MNIST; --group_fakes, the decode-once cache, the
    # host loop and -p on CelebA; K4 at the grouped batch.
    with CLOCK.phase("surface"):
        surface, b640, _ = surface_phase(dev, out_root, smi)
    for entry in kernels:
        k = keys[entry["name"]]
        entry["surface_launches"] = {run: counts[k] for run, counts in surface.items()}
        if k in b640:
            entry[f"b{5 * CB}_ms"], entry[f"b{5 * CB}_plain_ms"] = b640[k]

    # 5, 11, 13 and 14: the second process's results.
    with CLOCK.phase("beside"):
        res = beside.wait()
    for entry in kernels:
        k = keys[entry["name"]]
        entry["interop_launches"] = {run: counts.get(k, 0)
                                     for run, counts in res["interop"].items()}
        entry["parallel_launches"] = {run: [c[k] for c in by_rank]
                                      for run, by_rank in res["parallel"].items()}
        entry["tp_launches"] = {run: [c[k] for c in by_rank]
                                for run, by_rank in res["tp"].items()}
        entry["tp_engine_launches"] = {run: [c[k] for c in by_rank]
                                       for run, by_rank in res["tp_engines"].items()}

    # Every configuration of the plan was driven (see ``plan``).
    missing = [(kind, label) for kind, label, argv in plan()
               if (kind, config_key(argv)) not in CLOCK.driven]
    print(f"configurations driven: {len(CLOCK.driven)}; the plan's {len(plan())}, "
          f"{len(missing)} of them not driven")
    if missing:
        fail(f"the plan's configurations {missing} were not driven")

    # 15. Where the time went; the kernels line; 16. the result line.
    print_phase_seconds()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--parallel-rank":
        sys.exit(parallel_rank(sys.argv[2]))
    CLOCK = Clock()
    sys.exit(guarded(main))
