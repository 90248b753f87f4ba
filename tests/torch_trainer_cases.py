"""Configurations and checks shared by the tests/test_torch_trainer_*.py
files: the tiny MNIST configs (TINY, the DCResNet recipe DCRN), the CelebA
flagship's flags, and every flag combination that selects a route of the gc
D step with the route it must take (STEP_RUNNER_FLAGS), checked by
``check_step_runner_epoch``."""

import csv

import numpy as np
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.ops import pallas_clip
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner

TINY = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "32",
        "-tss", "160", "--manual_seed", "3"]
# The CelebA flagship's recipe (DCResNet gc, WGAN-GP on mean samples, G every
# 5th D step) on the MNIST DCResNet pair: 10 D steps of 8 rows per epoch.
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-bs", "8", "-tss", "80",
        "--manual_seed", "4"]
FLAGSHIP = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "128", "-tss", "12800",
            "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
            "--train_d_until_threshold", "1e18"]


# Flag combinations that the step runner serves, each with the route the gc D
# step must take for it.
DCRN_ON = DCRN + ["--train_d_until_threshold", "1e18"]     # G never gated off
STEP_RUNNER_FLAGS = {
    "pallas-combined": (TINY + ["--pallas", "true", "--grad_clip_split", "false"], "fused"),
    "combined": (TINY + ["--grad_clip_split", "false"], "materialized"),
    "chunk": (TINY + ["--per_sample_chunk", "5"], "materialized"),
    "pallas-with-chunk": (TINY + ["--pallas", "true", "--per_sample_chunk", "5"],
                          "materialized"),
    "pallas-epoch-off": (TINY + ["--pallas_epoch", "false"], "ghost"),
    "pallas-ghost-wins": (TINY + ["--pallas", "true", "--pallas_epoch", "false"], "ghost"),
    "n-d-steps": (TINY + ["--n_d_steps", "2"], "ghost"),
    "threshold": (TINY + ["--train_d_until_threshold", "0.5"], "ghost"),
    "per-layer": (TINY + ["-gcm", "constant-pl", "-cpl", "1", "2", "3", "4", "5", "6"], "ghost"),
    "per-layer-pallas": (TINY + ["-gcm", "constant-pl", "--grad_clip_split", "false",
                                 "--pallas", "true"], "fused"),
    "dcresnet-two-pass": (DCRN_ON + ["--conv_ghost", "false"], "two_pass"),
    "dcresnet-bf16-pallas": (DCRN_ON + ["--conv_ghost", "false", "--bf16", "true",
                                        "--pallas", "true"], "fused"),
    "dcresnet-per-layer": (DCRN_ON + ["-gcm", "constant-pl"], "conv_ghost"),
    "dcresnet-chunk": (DCRN_ON + ["--per_sample_chunk", "3"], "materialized"),
}



def check_step_runner_epoch(tmp_path, name):
    """Each combination parses, takes the step runner and its route, trains an
    epoch on the CPU and logs the JAX accountant's epsilon."""
    args, route = STEP_RUNNER_FLAGS[name]
    out = tmp_path / "run"
    tss = int(args[args.index("-tss") + 1])
    opt = toptions.parse(args + ["-ne", "1", "--log_every", str(tss), "--platform", "cpu",
                                 "-o", str(out)])
    tr = Trainer(opt)
    b = tr.builder
    assert isinstance(tr.runner, StepRunner)
    assert {"fused": b.fused_route, "materialized": b.materialized and not b.fused_route,
            "ghost": b.use_ghost, "two_pass": b.use_two_pass,
            "conv_ghost": b.use_conv_ghost}[route]
    launches = pallas_clip.leaves_weighted_sum_noise.launches
    assert tr.run() == 0
    # On the CPU the fused route runs K6's plain version: no launch is counted.
    assert pallas_clip.leaves_weighted_sum_noise.launches == launches
    assert tr.state.d_count == tr.n_batches
    assert tr.state.g_count == (0 if name == "threshold" else -(-tr.n_batches // opt.n_d_steps))
    with open(out / "log.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k in ("D Adv Loss", "D Real Loss", "D Fake Loss", "D Real Aux Loss"):
        assert np.isfinite(float(row[k])), k
    n_leaves = len(b.d_leaves)
    clip = np.asarray(row["Clipping Params"].strip("[]").split(), np.float32)
    assert clip.size == (n_leaves if b.per_layer else 1)
    if name == "per-layer":      # -cpl is in torch order, and so is the log column
        np.testing.assert_allclose(clip, [1, 2, 3, 4, 5, 6])
        assert tr.state.clipping == (2.0, 1.0, 4.0, 3.0, 6.0, 5.0)
    with open(out / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    ref = JaxRdpAccountant(batch_size=opt.batch_size, sample_size=tss,
                           noise_multiplier=opt.sigma)
    ref.step(tr.n_batches)
    np.testing.assert_allclose(eps - tr.mean_sample_privacy_cost,
                               ref.get_privacy_spent(opt.delta)[0], rtol=1e-9)
    for t in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(t).all()

