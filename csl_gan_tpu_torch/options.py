"""Config / flag system of the PyTorch port.

The same flag names, per-dataset default dicts, derived flags and validation
rules as the JAX package's options module, so an ``opt.txt`` written by either
package reads the same. Differences:

  - ``--platform {cpu,gpu}`` picks the torch device (default: gpu). There is
    no platform hook: the device is passed explicitly to every entry point.
  - Every flag whose code path is not ported yet raises
    ``NotImplementedError`` naming the flag (``check_ported``); the port never
    ignores a flag silently.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from argparse import Namespace
from datetime import datetime

# Per-dataset default dict (reference options.py:11-62).
MNIST_DEFAULTS = {
    "data_path": "/persist/datasets/mnist/",
    "model": "Vanilla",
    "im_size": 28,
    "n_epochs": 10000,
    "g_lr": 0.0002,
    "d_lr": 0.0002,
    "batch_size": 600,
    "batch_split_size": 60,
    "train_set_size": 60000,
    "g_latent_dim": 100,
    "n_d_steps": 1,
    "phase_gn4_max_f": -1,
    "g_label_emb_mode": "concat",
    "d_label_emb_mode": "concat",
    "aux_loss_type": "cross_entropy",
    "adam_b1": 0.9,
    "adam_b2": 0.999,
    "penalty": [],
    "iter_on_mean_samples": 0,
    "mean_sample_size": 5000,
    "mean_sample_noise_std": 0.22,
    "delta": 1e-5,
    "sigma": 5.0,
    "grad_clip_mode": "standard",
    "clipping_param": 4.0,
    "imm_sens_scaling_mode": "standard",
    "tm_m": 10,
    "tm_max_val": -1,
    "tm_min_val": 1,
    "save_every": 50,
    "log_every": 100000,  # rounded down to 1 epoch
    "sample_every": 600000,
    "sample_num": 100,
    "n_classes": 10,
    "weights_seed": 42,
}

CELEBA_DEFAULTS = {
    "data_path": "/persist/datasets/celeba/img_align_celeba/all/",
    "label_path": "/persist/datasets/celeba/Anno/list_attr_celeba.txt",
    "label_attr": "Male",
    "model": "DeepConvResNet",
    "im_size": 64,
    "n_epochs": 1000,
    "g_lr": 0.0001,
    "d_lr": 0.0001,
    "batch_size": 128,
    "batch_split_size": 32,
    "train_set_size": 180000,
    "public_set_size": 0,
    "g_latent_dim": 128,
    "n_d_steps": 5,
    "phase_gn4_max_f": 64,
    "g_label_emb_mode": "concat",
    "d_label_emb_mode": "concat",
    "aux_loss_type": "wasserstein",
    "adam_b1": 0.0,
    "adam_b2": 0.9,
    "penalty": ["WGAN-GP"],
    "iter_on_mean_samples": 0,
    "mean_sample_size": 1000,
    "mean_sample_noise_std": 0.12,
    "delta": 1e-6,
    "sigma": 0.5,
    "imm_sens_scaling_vec": [20, 2, 15, 1.5, 10, 1.5, 10, 1, 30],
    "imm_sens_scaling_mode": "standard",
    "imm_sens_per_param": True,
    "grad_clip_mode": "standard",
    "clipping_param": 200,
    "clipping_param_per_layer": [1000, 200, 1000, 100, 1000, 100, 1000, 5, 2500],
    "tm_m": 10,
    "tm_min_val": -1,
    "tm_max_val": 1,
    "save_every": 10,
    "log_every": 20000,
    "sample_every": 60000,
    "sample_num": 25,
    "n_classes": 2,
    "gp_lambda": 10,
}


def add_slash(path):
    return None if path is None else (path if path.endswith("/") else path + "/")


def fill_defaults(opt, default_dict):
    """Apply per-dataset defaults, overwriting only None/False values (the
    reference quirk, options.py:93-96)."""
    for key, val in default_dict.items():
        if key not in opt.__dict__ or opt.__dict__[key] is None or opt.__dict__[key] is False:
            opt.__dict__[key] = val


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flag set (reference flags plus its extensions)."""
    p = argparse.ArgumentParser()
    a = p.add_argument
    a("--weights_seed", type=int, default=42)
    a("--manual_seed", type=int, default=-1)
    a("dataset", type=str, choices=["MNIST", "CelebA"])
    a("-d", "--data_path", type=str, default=None)
    a("-lp", "--label_path", type=str, default=None)
    a("-la", "--label_attr", type=str, default=None)
    a("--model", type=str, choices=["Vanilla", "DeepConvResNet"], default=None)
    a("--im_size", type=int, default=None, choices=[64, 48])
    a("--download_mnist", default=False, action="store_true")
    a("-o", "--output_dir", type=str, default=None)
    a("-rp", "--resume_path", type=str, default=None)
    a("-re", "--resume_epochs", type=int, default=0)
    a("-ka", "--keep_args", type=str, nargs="*", default=[])
    a("-ne", "--n_epochs", type=int, default=None)
    a("--d_lr", type=float, default=None)
    a("--g_lr", type=float, default=None)
    a("-wd", "--weight_decay", type=float, default=0)
    a("-bs", "--batch_size", type=int, default=None)
    a("-bss", "--batch_split_size", type=int, default=None)
    a("-tss", "--train_set_size", type=int, default=None)
    a("-gd", "--g_device", type=str, default="cpu")
    a("-dd", "--d_device", type=str, default="cpu")
    a("-nw", "--num_workers", type=int, default=8)
    a("--g_latent_dim", type=int, default=None)
    a("--n_d_steps", type=int, default=None)
    a("--train_d_until_threshold", type=float, default=None)
    a("-cond", "--conditional", action="store_true", default=False)
    a("--g_label_emb_mode", type=str, choices=["embed", "concat"], default=None)
    a("--d_label_emb_mode", type=str, choices=["embed", "concat"], default=None)
    a("--conditional_arch", type=str, choices=["CGAN", "ACGAN", "WCGAN"], default="ACGAN")
    a("--aux_loss_type", type=str, choices=["wasserstein", "cross_entropy"], default=None)
    a("--aux_loss_scalar", type=float, default=1)
    a("--aux_penalty", type=str2bool, default=True)
    a("--d_fake_aux_loss", type=str2bool, default=True)
    a("--adam_b1", type=float, default=None)
    a("--adam_b2", type=float, default=None)
    a("--penalty", type=str, nargs="*",
      choices=[None, "WGAN-GP", "WGAN-GP1", "DRAGAN", "DRAGAN1"], default=None)
    a("-pss", "--public_set_size", type=int, default=0)
    a("-nms", "--num_mean_samples", type=int, default=0)
    a("-pupd", "--penalty_use_public_data", type=str2bool, default=True)
    a("-wi", "--warmup_iter", type=int, default=0)
    a("--mean_sample_size", type=int, default=None)
    a("--mean_sample_noise_std", type=float, default=None)
    a("--delta", type=float, default=None)
    a("--sigma", type=float, default=None)
    a("-eb", "--epsilon_budget", type=float, default=None)
    a("-dpm", "--dp_mode", type=str, choices=["gc", "is", "tm", "sv"], default=None)
    a("-ispp", "--imm_sens_per_param", type=str2bool, default=False)
    a("-issv", "--imm_sens_scaling_vec", type=float, nargs="*", default=None)
    a("-issm", "--imm_sens_scaling_mode", type=str,
      choices=["standard", "constant-pl", "moving-avg-pl"], default=None)
    a("--moving_avg_beta", type=float, default=0.9)
    a("-gcs", "--grad_clip_split", type=str2bool, default=True)
    a("-gcm", "--grad_clip_mode", type=str,
      choices=["standard", "adaptive", "constant-pl", "adaptive-pl"], default=None)
    a("-c", "--clipping_param", type=float, default=None)
    a("-cpl", "--clipping_param_per_layer", type=float, nargs="*", default=None)
    a("-as", "--adaptive_scalar", type=float, default=1.5)
    a("--adaptive_stat", choices=["mean", "max"], default="mean")
    a("--smooth_sens_t", type=float, default=0.01)
    a("--tm_m", type=int, default=None)
    a("--tm_max_val", type=float, default=None)
    a("--tm_min_val", type=float, default=None)
    a("--tm_rho_per_epoch", type=float, default=10)
    a("--tm_sens_compute_bs", type=float, default=None)
    a("-bpc", "--backprop_clip", type=str2bool, default=False)
    a("--bpc_back_clip_param", type=float, default=0.01)
    a("--bpc_back_clip_param_pl", type=float, nargs="*", default=None)
    a("--bpc_forward_clip_param", type=float, default=20)
    a("--bpc_forward_clip_param_pl", type=float, nargs="*", default=None)
    a("-bpcaas", "--bpc_auto_activation_scale", type=float, default=0.2)
    a("-bpcawgs", "--bpc_auto_weight_grad_scale", type=float, default=1e-3)
    a("--bpc_during_g_train", type=str2bool, default=True)
    a("--save_every", type=int, default=None)   # epochs
    a("--log_every", type=int, default=None)    # samples
    a("--sample_every", type=int, default=None)  # samples
    a("--sample_num", type=int, default=None)
    a("-p", "--profile_training", default=False, action="store_true")
    # Extensions of the JAX package, kept so its opt.txt files parse here.
    a("--mesh_shape", type=int, default=None)
    a("--fsdp", type=str2bool, default=False)
    a("--tp", type=int, default=1)
    a("--ref_pixel_shuffle", type=str2bool, default=False)
    a("--per_sample_chunk", type=int, default=None)
    a("--platform", type=str, choices=["cpu", "gpu"], default=None,
      help="Torch device: gpu (the default; raises when no CUDA device is "
           "visible) or cpu (the plain PyTorch versions of the kernels).")
    a("--rbg", type=str2bool, default=True)
    a("--multihost", type=str2bool, default=False)
    a("--coordinator_address", type=str, default=None)
    a("--num_processes", type=int, default=None)
    a("--process_id", type=int, default=None)
    a("--host_loop", type=str2bool, default=False)
    a("--bf16", type=str2bool, default=False)
    a("--poisson", type=str2bool, default=False)
    a("--conv_ghost", type=str2bool, default=True)
    a("--pallas", type=str2bool, default=False)
    a("--stop_on_g_freeze", type=int, default=0)
    a("--bf16_table", type=str2bool, default=True,
      help="Store the device image table [x | one-hot | label] in bfloat16; "
           "rows convert to fp32 inside the epoch kernel.")
    a("--u8_table", type=str2bool, default=False)
    a("--phase_gn4", type=str2bool, default=True,
      help="A TPU layout choice of the JAX package with identical values; accepted and ignored by the port.")
    a("--phase_carry", type=str2bool, default=True,
      help="A TPU layout choice of the JAX package with identical values; accepted and ignored by the port.")
    a("--phase_gn4_max_f", type=int, default=None,
      help="A TPU layout choice of the JAX package with identical values; accepted and ignored by the port.")
    a("--group_fakes", type=str2bool, default=False)
    a("--pallas_epoch", type=str2bool, default=True)
    return p


def derive_and_validate(opt) -> None:
    """Derived flags + validation rules (reference options.py:222-256)."""
    opt.log_every_epochs = -1 if opt.log_every < opt.train_set_size else opt.log_every // opt.train_set_size
    opt.sample_every_epochs = -1 if opt.sample_every < opt.train_set_size else opt.sample_every // opt.train_set_size
    opt.log_every = max((opt.log_every // opt.batch_size) * opt.batch_size, 1)
    opt.sample_every = max((opt.sample_every // opt.batch_size) * opt.batch_size, 1)

    opt.use_dp = opt.dp_mode is not None
    opt.use_grad_clip_per_layer = opt.grad_clip_mode != "standard" and opt.grad_clip_mode != "adaptive"
    opt.per_sample_grad = opt.dp_mode in ["gc", "tm", "sv"]
    opt.is_acgan = opt.conditional and opt.conditional_arch == "ACGAN"
    opt.use_aux_loss = opt.conditional and opt.conditional_arch in ["ACGAN", "WCGAN"]
    if opt.conditional_arch == "WCGAN" and opt.aux_penalty:
        opt.aux_penalty = False
    # The reference forces -1 for DP DeepConvResNet runs; like the JAX
    # package, only when the user set no value.
    tdut_user_set = opt.train_d_until_threshold is not None
    if not tdut_user_set:
        opt.train_d_until_threshold = 1e10
    if opt.model == "DeepConvResNet" and opt.use_dp and not tdut_user_set:
        print("Setting train_d_until_threshold to -1, which is generally "
              "recommended for WGAN using DP")
        opt.train_d_until_threshold = -1
    if opt.batch_size > opt.train_set_size:
        raise Exception(
            f"batch_size ({opt.batch_size}) exceeds train_set_size "
            f"({opt.train_set_size}): every epoch would run zero batches "
            "(full batches only) and the DP sampling rate would exceed 1. "
            "Lower -bs or raise -tss.")
    if (opt.g_label_emb_mode != "concat" or opt.d_label_emb_mode != "concat") and opt.model == "Vanilla":
        raise Exception("Vanilla model with embedded labels not implemented")


def validate_public_data(opt) -> None:
    """The JAX package's rules on mean samples and public data
    (options.py:542-563)."""
    if opt.num_mean_samples > 0 and opt.mean_sample_size > opt.train_set_size:
        raise Exception(
            f"mean_sample_size ({opt.mean_sample_size}) exceeds "
            f"train_set_size ({opt.train_set_size}): the mean-sampler "
            "subsampling rate would exceed 1. Lower --mean_sample_size or "
            "raise -tss.")
    if len(opt.penalty) > 0 and opt.use_dp and opt.penalty_use_public_data \
            and opt.public_set_size < 1 and opt.num_mean_samples < 1:
        raise Exception("In order to enable gradient penalty using public data, "
                        "please enable mean sampling by setting num_mean_samples "
                        "or public data by setting public_set_size.")


def _vanilla(o) -> bool:
    return o.model == "Vanilla"


# (flag, test on the parsed opt) for every option whose path is not ported.
# The vanilla MNIST flagship runs on the epoch kernel K1, every other ported
# configuration on the step runner (training/loop.py).
_NOT_PORTED = [
    ("--dp_mode (only gc is ported)", lambda o: o.dp_mode not in (None, "gc")),
    ("--penalty on the vanilla model", lambda o: bool(o.penalty) and _vanilla(o)),
    ("--penalty DRAGAN", lambda o: any(p.startswith("DRAGAN") for p in o.penalty)),
    ("-pupd false (the per-sample penalty)",
     lambda o: bool(o.penalty) and o.use_dp and not o.penalty_use_public_data),
    ("--poisson", lambda o: o.poisson),
    ("--grad_clip_mode adaptive / adaptive-pl (adaptive clipping)",
     lambda o: (o.grad_clip_mode or "standard").startswith("adaptive")),
    ("--weight_decay", lambda o: (o.weight_decay or 0) != 0),
    ("--resume_path", lambda o: o.resume_path is not None),
    ("--fsdp", lambda o: o.fsdp),
    ("--tp", lambda o: o.tp != 1),
    ("--mesh_shape", lambda o: (o.mesh_shape or 1) != 1),
    ("--multihost", lambda o: o.multihost),
    ("--backprop_clip", lambda o: o.backprop_clip),
    ("--num_mean_samples on the vanilla model",
     lambda o: o.num_mean_samples > 0 and _vanilla(o)),
    ("--public_set_size", lambda o: o.public_set_size > 0),
    ("--warmup_iter", lambda o: o.warmup_iter > 0),
    ("--host_loop", lambda o: o.host_loop),
    ("--bf16 on the vanilla model", lambda o: o.bf16 and _vanilla(o)),
    ("--u8_table", lambda o: o.u8_table),
    ("--group_fakes", lambda o: o.group_fakes),
    ("--ref_pixel_shuffle", lambda o: o.ref_pixel_shuffle),
    ("--profile_training", lambda o: o.profile_training),
    ("--download_mnist", lambda o: o.download_mnist),
    ("--log_every below one epoch of samples", lambda o: o.log_every_epochs < 0),
    ("--stop_on_g_freeze", lambda o: o.stop_on_g_freeze > 0),
    ("--model DeepConvResNet without -dpm gc",
     lambda o: not _vanilla(o) and o.dp_mode != "gc"),
    ("--g_label_emb_mode embed", lambda o: o.g_label_emb_mode != "concat"),
    ("unconditional training (--conditional)", lambda o: not o.conditional),
    ("--conditional_arch CGAN / WCGAN (only ACGAN is ported)",
     lambda o: o.conditional_arch != "ACGAN"),
    ("--aux_loss_type wasserstein on the vanilla model",
     lambda o: o.aux_loss_type != "cross_entropy" and _vanilla(o)),
    ("--n_classes outside 2..16", lambda o: not 2 <= o.n_classes <= 16),
    ("--batch_size not a multiple of 8", lambda o: o.batch_size % 8 != 0),
]


def check_ported(opt) -> None:
    """Raise NotImplementedError naming the first flag outside the slice."""
    for flag, bad in _NOT_PORTED:
        if bad(opt):
            raise NotImplementedError(f"{flag} is not ported yet")


def parse(argv=None) -> Namespace:
    """Parse CLI args into the opt namespace (reference options.py:113-281)."""
    opt = build_parser().parse_args(argv)
    opt.data_path = add_slash(opt.data_path)
    opt.resume_path = add_slash(opt.resume_path)
    opt.output_dir = add_slash(opt.output_dir)
    opt.cpl_user_set = opt.clipping_param_per_layer is not None
    fill_defaults(opt, MNIST_DEFAULTS if opt.dataset == "MNIST" else CELEBA_DEFAULTS)
    derive_and_validate(opt)
    check_ported(opt)
    validate_public_data(opt)

    if not opt.output_dir:
        now = datetime.now()
        opt.output_dir = (now.strftime("output/%m-%d-%H:%M-") + opt.dataset
                          + "-g" + str(opt.g_device)[-1]
                          + "-d" + str(opt.d_device)[-1] + "/")
    for path in [opt.output_dir, opt.output_dir + "samples/",
                 opt.output_dir + "saves/"]:
        os.makedirs(path, exist_ok=True)
    if opt.manual_seed < 0:
        opt.manual_seed = random.randint(1, 1000000)
    return opt


def save_opt(opt, path) -> None:
    with open(path, "w") as f:
        json.dump(opt.__dict__, f)

