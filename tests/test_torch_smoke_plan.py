"""chip_smoke.py keeps what its checks need (CPU: the module is imported,
nothing runs on a card): every bound constant at the value it had when the
smoke was cut to time (commit db2356d), every configuration that smoke drove
through a Trainer, a rank process or the CLI still in the smoke's plan, and
every phase that main() runs named in the phase_seconds line."""

import ast
import inspect
import shlex
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

# The bounds of db2356d's chip_smoke.py, by name.
BOUNDS = {
    "REL_BOUND": 1e-4, "CONV_BOUND": 1e-4, "GN_BOUND": 1e-3, "GN_PARAM_BOUND": 1e-4,
    "GN_EDGE": 2.0 ** -16, "STEP_BOUND_D": 1e-4, "STEP_BOUND_G": 2e-2,
    "STEP_BOUND_MET": 1e-4, "STEP_BOUND_FAKES": 1e-4, "STEP_BF16_FACTOR": 3.0,
    "K6_SUM_BOUND": 1e-5, "K6_NOISE_BOUND": 1e-4, "K6_STD": 2.5, "K6_STEP_BOUND": 1e-4,
    "GHOST_BOUND": 1e-4, "RESUME_FACTOR": 3.0, "INCEPTION_BOUND": 1e-4,
    "SURF_GROUP_FACTOR": 3.0, "PAR_FACTOR": 3.0, "PAR_FLOOR": 2.0 ** -20,
    "PAR_FP32_BOUND": 1e-4,
}

# (kind, label, argv) of every configuration db2356d's smoke drove through a
# Trainer of its own process, a rank process or the CLI, as its phases built
# them (output, seed and rank plumbing aside).
DB2356D_RUNS = (
    ('Trainer', 'MNIST flagship',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 -ne 2 --log_every 120000'),
    ('Trainer', 'CelebA flagship',
     'CelebA --conditional -dpm gc -bs 128 -tss 12800 -nms 1 --mean_sample_size 8 --bf16 '
     'true --train_d_until_threshold 1e18 -ne 2 --log_every 25600'),
    ('Trainer', 'saves MNIST 2 epochs',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 '
     '--manual_seed 1 --sample_every 60000 -ne 2 --save_every 1'),
    ('Trainer', 'saves MNIST 1 epoch',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 '
     '--manual_seed 1 --sample_every 60000 -ne 1'),
    ('Trainer', 'saves MNIST resumed',
     'MNIST -rp DIR -re 1 -ne 2 -ka n_epochs'),
    ('Trainer', 'saves CelebA 2 epochs',
     'CelebA --conditional -dpm gc -bs 128 -tss 12800 -nms 1 --mean_sample_size 8 --bf16 '
     'true --train_d_until_threshold 1e18 --log_every 12800 --sample_every 6400 '
     '--manual_seed 1 -ne 2 --save_every 1'),
    ('Trainer', 'saves CelebA 1 epoch',
     'CelebA --conditional -dpm gc -bs 128 -tss 12800 -nms 1 --mean_sample_size 8 --bf16 '
     'true --train_d_until_threshold 1e18 --log_every 12800 --sample_every 6400 '
     '--manual_seed 1 -ne 1'),
    ('Trainer', 'saves CelebA resumed',
     'CelebA -rp DIR -re 1 -ne 2 -ka n_epochs'),
    ('CLI', 'SIGTERM',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 '
     '--manual_seed 1 -ne 100000'),
    ('Trainer', 'SIGTERM resumed',
     'MNIST -rp DIR -re 1 -ne 2 -ka n_epochs'),
    ('Trainer', 'path 1',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --pallas true '
     '--grad_clip_split false -ne 2 --log_every 120000'),
    ('Trainer', 'path 2',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 '
     'true --train_d_until_threshold 1e18 --conv_ghost false --pallas true -ne 2 '
     '--log_every 2560'),
    ('Trainer', 'MNIST is',
     'MNIST --conditional --sigma 10 -bs 600 -tss 60000 -dpm is -ne 1 --log_every 60000'),
    ('Trainer', 'MNIST is per-param',
     'MNIST --conditional --sigma 10 -bs 600 -tss 60000 -dpm is -ispp true -ne 1 '
     '--log_every 60000'),
    ('Trainer', 'MNIST is moving-avg-pl',
     'MNIST --conditional --sigma 10 -bs 600 -tss 60000 -dpm is -issm moving-avg-pl '
     '--sigma 0.01 -ne 1 --log_every 60000'),
    ('Trainer', 'MNIST tm',
     'MNIST --conditional --sigma 10 -bs 600 -tss 60000 -dpm tm -ne 1 --log_every 60000'),
    ('Trainer', 'MNIST sv',
     'MNIST --conditional --sigma 10 -bs 600 -tss 60000 -dpm sv -ne 1 --log_every 60000'),
    ('Trainer', 'CelebA is',
     'CelebA --conditional -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 -dpm is -ne 1 --log_every 1280'),
    ('Trainer', 'CelebA tm',
     'CelebA --conditional -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 -dpm tm -ne 1 --log_every 1280'),
    ('Trainer', 'CelebA no DP',
     'CelebA --conditional -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 -ne 1 --log_every 1280'),
    ('Trainer', 'CelebA CGAN',
     'CelebA -dpm gc -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 --conditional --conditional_arch CGAN -ne 2 '
     '--log_every 2560'),
    ('Trainer', 'CelebA WCGAN',
     'CelebA -dpm gc -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 --conditional --conditional_arch WCGAN -ne 2 '
     '--log_every 2560'),
    ('Trainer', 'CelebA unconditional',
     'CelebA -dpm gc -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 -ne 2 --log_every 2560'),
    ('Trainer', 'CelebA ACGAN embed',
     'CelebA -dpm gc -bs 128 -tss 1280 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 --conditional --g_label_emb_mode embed -ne 2 '
     '--log_every 2560'),
    ('Trainer', 'MNIST CGAN',
     'MNIST -dpm gc --sigma 10 -bs 600 -tss 60000 --conditional --conditional_arch CGAN '
     '-ne 2 --log_every 120000'),
    ('Trainer', 'MNIST WCGAN',
     'MNIST -dpm gc --sigma 10 -bs 600 -tss 60000 --conditional --conditional_arch WCGAN '
     '-ne 2 --log_every 120000'),
    ('Trainer', 'MNIST unconditional',
     'MNIST -dpm gc --sigma 10 -bs 600 -tss 60000 -ne 2 --log_every 120000'),
    ('Trainer', 'MNIST warmup',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 -nms 2 --mean_sample_size '
     '10 -wi 2 -ne 2 --log_every 120000'),
    ('Trainer', 'CelebA public adaptive',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -pss 1280 -gcm adaptive -wi 2 -ne 2 --log_every 2560'),
    ('Trainer', 'CelebA mean-sample adaptive-pl',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -gcm adaptive-pl -nms 1 --mean_sample_size 8 -wi 2 -ne 2 --log_every 2560'),
    ('Trainer', 'path 1 adaptive',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false -gcm adaptive -nms 1 --mean_sample_size 10 -ne 2 --log_every '
     '12000'),
    ('Trainer', 'CelebA B 50',
     'CelebA --conditional -dpm gc -bs 50 -tss 500 -nms 1 --mean_sample_size 8 --bf16 true '
     '--train_d_until_threshold 1e18 -ne 2 --log_every 1000'),
    ('Trainer', 'MNIST B 50',
     'MNIST --conditional -dpm gc --sigma 10 -bs 50 -tss 5000 -ne 2 --log_every 10000'),
    ('Trainer', 'CelebA Poisson',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --poisson true -ne 2 --log_every 2560'),
    ('Trainer', 'MNIST Poisson',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --poisson true -ne 2 '
     '--log_every 120000'),
    ('Trainer', 'CelebA per-sample penalty',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -pupd false --pallas true -ne 2 --log_every 2560'),
    ('Trainer', 'MNIST per-sample DRAGAN',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --penalty DRAGAN1 -pupd '
     'false --pallas true -ne 2 --log_every 12000'),
    ('Trainer', 'CelebA DRAGAN',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --penalty DRAGAN -ne 2 --log_every 2560'),
    ('Trainer', 'MNIST bpc',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --backprop_clip true '
     '--pallas true -ne 2 --log_every 12000'),
    ('Trainer', 'MNIST is bpc',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 -dpm is --backprop_clip '
     'true -ne 2 --log_every 12000'),
    ('Trainer', 'bpc bounds',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --backprop_clip true '
     '--pallas true --sigma 0 -ne 1'),
    ('Trainer', 'interop resumed',
     'CelebA -rp DIR -re 1 -ne 2 -ka n_epochs'),
    ('Trainer', 'MNIST flagship',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 -ne 1'),
    ('Trainer', 'CelebA flagship',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1'),
    ('Trainer', 'MNIST -wd',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 -wd 1e-4 '
     '-ne 1'),
    ('Trainer', 'MNIST u8 table',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 '
     '--u8_table true -ne 1'),
    ('Trainer', 'MNIST bf16',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 --bf16 '
     'true -ne 1'),
    ('Trainer', 'MNIST sub-epoch cadence',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 '
     '--log_every 12000 --sample_every 12000 -ne 1'),
    ('Trainer', 'CelebA group_fakes',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --group_fakes true -ne 1'),
    ('Trainer', 'CelebA cache',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -d IMG -lp ATTR -ne 1'),
    ('Trainer', 'CelebA host loop',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -d IMG -lp ATTR --host_loop true '
     '-ne 1'),
    ('Trainer', 'CelebA profile',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -p -ne 1'),
    ('Trainer', 'CelebA one rank',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1'),
    ('Trainer', 'path 1 one rank',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false -ne 1'),
    ('Trainer', 'MNIST ghost one rank',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -ne 1'),
    ('Trainer', 'MNIST plain',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 -ne 1'),
    ('rank step', 'CelebA step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA G step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'CelebA 2 ranks',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'CelebA 2 ranks fsdp',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --fsdp true -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'path 1 2 ranks',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false -ne 1 --multihost true --coordinator_address localhost:1 '
     '--num_processes 2 --process_id 0'),
    ('rank run', 'MNIST ghost 2 ranks',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'MNIST NCCL',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 60000 --log_every 60000 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 1 --process_id 0'),
    ('Trainer', 'tp CelebA one rank',
     'CelebA --conditional -dpm gc -bs 128 -tss 640 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -ne 1'),
    ('Trainer', 'tp MNIST ghost one rank',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -ne 1'),
    ('Trainer', "CelebA tm (one-rank step's Trainer)",
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -dpm tm -ne 1'),
    ('Trainer', "CelebA Poisson (one-rank step's Trainer)",
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --poisson true -ne 1'),
    ('Trainer', "CelebA adaptive (one-rank step's Trainer)",
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -gcm adaptive -ne 1'),
    ('Trainer', "CelebA -pupd false (one-rank step's Trainer)",
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -pupd false --pallas true -ne 1'),
    ('Trainer', "CelebA DRAGAN (one-rank step's Trainer)",
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --penalty DRAGAN -ne 1'),
    ('Trainer', "MNIST is (one-rank step's Trainer)",
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'is -ne 1'),
    ('Trainer', "MNIST is per-param (one-rank step's Trainer)",
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'is -ispp true -ne 1'),
    ('Trainer', "MNIST sv (one-rank step's Trainer)",
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'sv -ne 1'),
    ('Trainer', "MNIST bpc (one-rank step's Trainer)",
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false '
     '--backprop_clip true --pallas true -ne 1'),
    ('Trainer', 'CelebA Poisson one rank',
     'CelebA --conditional -dpm gc -bs 128 -tss 640 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --poisson true -ne 1'),
    ('Trainer', 'path 1 adaptive one rank',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false -gcm adaptive -nms 1 --mean_sample_size 10 -ne 1'),
    ('rank step', 'CelebA tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 640 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --tp 2 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'CelebA tp 2 ranks',
     'CelebA --conditional -dpm gc -bs 128 -tss 640 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --tp 2 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'path 1 tp 2 ranks',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false --tp 2 -ne 1 --multihost true --coordinator_address '
     'localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA tm tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -dpm tm --tp 2 -ne 1 --multihost '
     'true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA Poisson tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --poisson true --tp 2 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA adaptive tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 -gcm adaptive --tp 2 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA -pupd false tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -pupd false --pallas true --tp 2 -ne 1 --multihost true --coordinator_address '
     'localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'CelebA DRAGAN tp step',
     'CelebA --conditional -dpm gc -bs 128 -tss 1280 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --penalty DRAGAN --tp 2 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'MNIST is tp step',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'is --tp 2 -ne 1 --multihost true --coordinator_address localhost:1 --num_processes 2 '
     '--process_id 0'),
    ('rank step', 'MNIST is per-param tp step',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'is -ispp true --tp 2 -ne 1 --multihost true --coordinator_address localhost:1 '
     '--num_processes 2 --process_id 0'),
    ('rank step', 'MNIST sv tp step',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false -dpm '
     'sv --tp 2 -ne 1 --multihost true --coordinator_address localhost:1 --num_processes 2 '
     '--process_id 0'),
    ('rank step', 'MNIST bpc tp step',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false '
     '--backprop_clip true --pallas true --tp 2 -ne 1 --multihost true '
     '--coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'CelebA Poisson tp 2 ranks',
     'CelebA --conditional -dpm gc -bs 128 -tss 640 --bf16 true --train_d_until_threshold '
     '1e18 -nms 1 --mean_sample_size 8 --log_every 1280 --poisson true --tp 2 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank run', 'path 1 adaptive tp 2 ranks',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas true '
     '--grad_clip_split false -gcm adaptive -nms 1 --mean_sample_size 10 --tp 2 -ne 1 '
     '--multihost true --coordinator_address localhost:1 --num_processes 2 --process_id 0'),
    ('rank step', 'MNIST tp step dp2',
     'MNIST --conditional -dpm gc --sigma 10 -bs 600 -tss 6000 --pallas_epoch false --tp 2 '
     '-ne 1 --multihost true --coordinator_address localhost:1 --num_processes 4 '
     '--process_id 0'),
)


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_bound_keeps_its_value(name):
    assert getattr(cs, name) == BOUNDS[name]


def test_every_configuration_of_db2356d_is_still_driven():
    planned = {(kind, cs.config_key(argv)) for kind, _, argv in cs.plan()}
    missing = [(kind, label) for kind, label, argv in DB2356D_RUNS
               if (kind, cs.config_key(shlex.split(argv))) not in planned]
    assert not missing, missing


def test_config_key_leaves_out_only_the_run():
    key = cs.config_key
    base = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "128", "-tss", "1280"]
    assert key(base + ["-ne", "2", "--log_every", "2560", "-o", "a", "--manual_seed", "1"]) \
        == key(base + ["-ne", "1", "--log_every", "1280", "-o", "b"]) == key(base)
    assert key(base + ["--log_every", "640"]) != key(base)        # a sub-epoch cadence
    assert key(base + ["--poisson", "true"]) != key(base)
    assert key(base + ["-d", "x"]) == key(base + ["-d", "y"]) != key(base)
    mh = ["--multihost", "true", "--coordinator_address", "localhost:1", "--process_id"]
    assert key(base + mh + ["0", "--num_processes", "2"]) \
        == key(base + mh + ["1", "--num_processes", "2"]) \
        != key(base + mh + ["0", "--num_processes", "4"])


def _phases_run():
    """The phases main() runs: those it names in CLOCK.phase(...) and the
    standalone flags' (``ALONE``)."""
    names = set(cs.ALONE.values())
    for fn in (cs.run_phases, cs.beside_phases):
        for node in ast.walk(ast.parse(inspect.getsource(fn))):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "phase" \
                    and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def test_phase_seconds_names_every_phase_main_runs():
    run = _phases_run()
    assert run and run <= set(dict(cs.PHASES)), run - set(dict(cs.PHASES))
    assert set(cs.BESIDE) <= run
    clock = cs.Clock()
    for name in run:
        with clock.phase(name):
            with clock.item("something"):
                pass
    line = clock.line()["phase_seconds"]
    assert set(line["phases"]) == run
    assert all(f"{name}: something" in line["items"] for name in run)
    with pytest.raises(ValueError):
        with clock.phase("no such phase"):
            pass


def test_every_engine_step_of_phase_14_has_a_rank_set():
    sets = [name for names in cs.TP_STEP_SETS for name in names]
    assert sorted(sets) == sorted(["CelebA tp step"] + [f"{n} tp step"
                                                        for n, _, _ in cs.TP_ENGINE_STEPS])


def test_the_download_configuration_is_planned():
    """The download configuration: the MNIST flagship under
    --download_mnist on a data directory of its own, once in the plan."""
    planned = [(kind, cs.config_key(argv)) for kind, _, argv in cs.plan()]
    want = ("Trainer", cs.config_key(cs.MNIST_FLAGSHIP + ["--download_mnist", "-d", "x", "-ne",
                                                          "1", "--log_every", "60000"]))
    assert planned.count(want) == 1
    assert [k for k in planned if ("download_mnist", "True") in k[1]] == [want]


def test_the_smoke_mirror_is_what_the_loader_downloads(tmp_path, monkeypatch):
    """``write_mnist_mirror`` of ``quantized_mnist`` (the synthetic set cut
    to a thousandth here) writes IDX files that the port's loader fetches,
    behind a missing mirror, and reads as the quantized pixels / 255 and
    the labels."""
    import numpy as np
    from csl_gan_tpu_torch import options as toptions
    from csl_gan_tpu_torch.data import mnist

    names = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    synthetic = mnist.synthetic_mnist
    monkeypatch.setattr(mnist, "synthetic_mnist", lambda n, seed: synthetic(n // 1000, seed))
    monkeypatch.setitem(toptions.MNIST_DEFAULTS, "data_path", str(tmp_path / "none") + "/")
    arrays = cs.quantized_mnist()
    assert sorted(arrays) == sorted(names)
    url = cs.write_mnist_mirror(tmp_path / "mirror", arrays)
    assert url == (tmp_path / "mirror").as_uri() + "/"
    monkeypatch.setattr(mnist, "_MIRRORS", ((tmp_path / "none").as_uri() + "/", url))
    for train, seed, (img, lbl) in ((True, 0, names[:2]), (False, 1, names[2:])):
        x, y = mnist.load_mnist(str(tmp_path / "data"), train=train, download=True)
        sx, sy = synthetic(len(x), seed)
        assert np.array_equal(x, np.rint(sx * 255.0).astype(np.uint8) / np.float32(255.0))
        assert np.array_equal(y, sy) and np.array_equal(y, arrays[lbl])
        assert x.shape == (60 if train else 10, 28, 28, 1) and arrays[img].dtype == np.uint8
    assert sorted(p.name for p in (tmp_path / "data" / "MNIST" / "raw").iterdir()) == \
        sorted(n + ".gz" for n in names)
