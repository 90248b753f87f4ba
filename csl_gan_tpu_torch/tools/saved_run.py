"""A run directory's saves as the evaluation tools read them: the options
of ``opt.txt`` and the state of ``saves/{G,D}-N``, written by either
package or converted from the reference's (``convert_reference_checkpoint``:
its ``opt.txt`` sets ``ref_pixel_shuffle``, so the G upsamples as the
reference's does)."""

from __future__ import annotations

import os

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.loop import resolve_device
from csl_gan_tpu_torch.training.steps import StepBuilder


def load_run(path: str, label: int, platform=None, with_d: bool = True):
    """(opt, builder, state, epoch) of saves/G-label (and D-label) of the run
    in `path`, on the card unless `platform` is "cpu"; raises when no CUDA
    device is visible. The saved ``--platform`` is not used: a JAX run's may
    say ``tpu``."""
    opt = options.load_opt(os.path.join(path, "opt.txt"))
    opt.platform = platform
    G, D = init_models(opt, resolve_device(opt))
    builder = StepBuilder(opt, G, D)
    state, epoch = checkpoint.load_g(os.path.join(path, "saves", f"G-{label}"),
                                     builder.init_state())
    if with_d:
        state, epoch, _, _ = checkpoint.load_d(
            os.path.join(path, "saves", f"D-{label}"), state)
    return opt, builder, state, epoch


def add_device_flag(parser) -> None:
    parser.add_argument("-d", "--device", "--platform", dest="device", type=str,
                        choices=["cpu", "gpu"], default=None,
                        help="cpu runs the plain PyTorch versions of the kernels; "
                             "by default the tool runs on the card and raises "
                             "when no CUDA device is visible")
