"""One full DP train step of the MNIST flagship over N gloo ranks on the CPU
(the port's counterpart of the JAX package's ``dryrun_multichip``):

    python -m csl_gan_tpu_torch.parallel.dryrun N

Each rank builds the Trainer of ``MNIST --conditional -dpm gc --sigma 10``
at ``-bs 8N`` on the data axis and runs one D step (the ghost-clipped real
pass on its 8 rows, the reduced sums, the noise from rank 0) and its G
step through the step runner; rank 0 prints the step's D and G losses as a
JSON line and the run fails unless both, and every parameter, are finite.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
from argparse import Namespace

import torch

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.parallel import launch


def _rank(opt, mesh, n: int) -> None:
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="csl_gan_dryrun_") as out:
        b = 8 * n
        topt = options.parse(["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10",
                              "-bs", str(b), "-tss", str(4 * b), "-ne", "1",
                              "--manual_seed", "0", "--platform", "cpu", "-o", out])
        from csl_gan_tpu_torch.training.loop import Trainer
        tr = Trainer(topt, mesh)
        runner = tr.step_runner
        sums = [{}, {}, 0]
        state = runner.run_segment(tr.state, runner.epoch_source(tr.gen_perm), tr.gen, 0, 1,
                                   sums, runner.noise_stds(tr.state))
        d_loss = float(sums[0]["d_adv_loss"])
        g_loss = float(sums[1]["g_adv_loss"])
        finite = all(bool(torch.isfinite(v).all())
                     for tree in (state.d_params, state.g_params) for v in tree.values())
        if not (finite and math.isfinite(d_loss) and math.isfinite(g_loss)):
            raise RuntimeError(f"rank {mesh.rank}: the step is not finite "
                               f"(D {d_loss}, G {g_loss}, params finite: {finite})")
        if mesh.is_main:
            print(json.dumps({"ranks": n, "batch": b, "backend": mesh.backend,
                              "d_adv_loss": d_loss, "g_adv_loss": g_loss}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks (CPU processes over gloo)")
    n = ap.parse_args(argv).n
    if n < 1:
        raise SystemExit("N must be at least 1")
    launch.spawn(_rank, n, Namespace(platform="cpu", fsdp=False), n)


if __name__ == "__main__":
    main()
