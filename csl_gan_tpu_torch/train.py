"""Training CLI of the PyTorch port:

    python -m csl_gan_tpu_torch.train MNIST --conditional -dpm gc --sigma 10 -bs 600

Runs on the GPU; ``--platform cpu`` runs the plain PyTorch versions of the
kernels on the CPU. Flags outside the ported slice raise NotImplementedError.
"""

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.training.loop import run_training


def main(argv=None):
    run_training(options.parse(argv))


if __name__ == "__main__":
    main()
