"""Training CLI of the PyTorch port:

    python -m csl_gan_tpu_torch.train MNIST --conditional -dpm gc --sigma 10 -bs 600

Runs on the GPU; ``--platform cpu`` runs the plain PyTorch versions of the
kernels on the CPU. Flags outside the ported slice raise NotImplementedError.

Multi-device runs (csl_gan_tpu_torch/parallel): ``--mesh_shape N`` starts N
ranks on this host (one card each, or N CPU ranks over gloo under
``--platform cpu``); ``--multihost`` makes this process rank
``--process_id`` of ``--num_processes`` meeting at
``--coordinator_address``. Ranks other than 0 write into a scratch
directory of their own (JAX train.py:28-41), removed at the end unless
``-p`` left a rank's trace there; ``--fsdp`` shards the model state over the
ranks; ``--tp N`` lays them out as (data, model) = (ranks / N, N), G and D
column-parallel over the model axis (parallel/mesh.py).
"""

import os
import shutil
import tempfile

import torch.distributed as dist

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.parallel import launch
from csl_gan_tpu_torch.training.loop import run_training


def run_rank(opt, mesh):
    """One rank's training; ranks other than 0 write to scratch. Returns
    the rank's Trainer."""
    scratch = None
    if not mesh.is_main:
        scratch = tempfile.mkdtemp(prefix="csl_gan_scratch_")
        opt.output_dir = options.add_slash(scratch)
        for sub in ["samples", "saves", "code"]:
            os.makedirs(opt.output_dir + sub, exist_ok=True)
    try:
        return run_training(opt, mesh)
    finally:
        if scratch is not None and not opt.profile_training:
            shutil.rmtree(scratch, ignore_errors=True)


def main(argv=None):
    """Train as the options say; returns this process's Trainer (None for
    the parent of spawned ranks)."""
    opt = options.parse(argv)
    if opt.multihost:
        mesh = launch.init_multihost(opt)
        try:
            return run_rank(opt, mesh)
        finally:
            dist.destroy_process_group()
    world = launch.world_size(opt)
    if world > 1:
        launch.spawn(run_rank, world, opt)
        return None
    return run_training(opt)


if __name__ == "__main__":
    main()
