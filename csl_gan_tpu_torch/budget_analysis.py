"""Offline epsilon analysis of a run directory of either package (the port's
counterpart of the root tool budget_analysis.py):

    python -m csl_gan_tpu_torch.budget_analysis <output_dir> <epochs>

Reads <output_dir>/opt.txt and prints (epsilon, best_alpha) after `epochs`
epochs on the FULL dataset (60000 MNIST / 202599 CelebA, as the reference
counts, budget_analysis.py:79), over the wider alpha grid of the reference's
tool. The tm and sv modes print (epsilon, rho) from their zCDP ledger. No
model is built and no device is used.
"""

import argparse

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.privacy import rdp
from csl_gan_tpu_torch.privacy.accountant import RdpAccountant, ZcdpAccountant


def analyze(opt, epochs: int):
    dataset_size = 60000 if opt.dataset == "MNIST" else 202599
    steps = dataset_size * epochs / opt.batch_size
    if opt.dp_mode in ("tm", "sv"):
        steps_per_epoch = max(1, opt.train_set_size // opt.batch_size)
        acc = ZcdpAccountant(
            rho_per_step=getattr(opt, "tm_rho_per_epoch", 10) / steps_per_epoch,
            steps=steps)
    else:
        acc = RdpAccountant(batch_size=opt.batch_size, sample_size=opt.train_set_size,
                            noise_multiplier=opt.sigma, alphas=rdp.BUDGET_TOOL_ALPHAS,
                            steps=steps)
    return acc.get_privacy_spent(opt.delta)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="Path to output folder containing opt.txt")
    parser.add_argument("epochs", type=int)
    args = parser.parse_args(argv)
    opt = options.load_opt(options.add_slash(args.path) + "opt.txt")
    print(analyze(opt, args.epochs))


if __name__ == "__main__":
    main()
