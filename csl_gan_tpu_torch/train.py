"""Training CLI of the PyTorch port:

    python -m csl_gan_tpu_torch.train MNIST --conditional -dpm gc --sigma 10 -bs 600

Runs on the GPU; ``--platform cpu`` runs the plain PyTorch versions of the
kernels on the CPU. ``--download_mnist`` fetches MNIST into
``<data_path>/MNIST/raw`` first, once for all ranks of a run, and fails
when no mirror answers.

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
from csl_gan_tpu_torch.data import mnist
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


def fetch_mnist_once(opt, mesh=None) -> None:
    """Under ``--download_mnist``, fetch MNIST for every rank of the run
    before any rank loads it, so that the ranks' own loads find the files
    and none reads a file that another is writing: here, before ``spawn``
    starts the ranks; under ``--multihost`` (``mesh``), by the first rank
    of each host (``launch.local_layout``) while the others wait, every
    rank raising the error of any that failed."""
    if not (opt.download_mnist and opt.dataset == "MNIST"):
        return
    if mesh is None:
        mnist.fetch_mnist(opt.data_path)
        return
    error = None
    if launch.local_layout(mesh.rank)[0] == 0:
        try:
            mnist.fetch_mnist(opt.data_path)
        except Exception as e:
            error = f"rank {mesh.rank}: {e}"
    errors = [None] * mesh.world
    dist.all_gather_object(errors, error)
    failed = [e for e in errors if e is not None]
    if failed:
        raise RuntimeError(failed[0])


def main(argv=None):
    """Train as the options say; returns this process's Trainer (None for
    the parent of spawned ranks)."""
    opt = options.parse(argv)
    if opt.multihost:
        mesh = launch.init_multihost(opt)
        try:
            fetch_mnist_once(opt, mesh)
            return run_rank(opt, mesh)
        finally:
            dist.destroy_process_group()
    world = launch.world_size(opt)
    if world > 1:
        fetch_mnist_once(opt)
        launch.spawn(run_rank, world, opt)
        return None
    return run_training(opt)


if __name__ == "__main__":
    main()
