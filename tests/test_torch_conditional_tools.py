"""The evaluation tools and resume on runs of the port's new variants, on the
CPU: ``gensamples``, ``temp_file`` and ``mem_inf_attack`` read one-epoch
saves of an unconditional vanilla run of either package and of the MNIST
DCResNet WCGAN and embedded-G runs (no labels when unconditional, as the JAX
tools do), and each package continues the other's unconditional run from
its saves with epsilon continued.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.training.loop import Trainer
from torch_conditional_cases import TRAIN_DCRN

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


TOOL_RUNS = {
    "vanilla-uncond": ["MNIST", "-dpm", "gc", "-tss", "200", "-bs", "40"],
    "dcresnet-wcgan": TRAIN_DCRN + ["-dpm", "gc", "--conditional", "--conditional_arch", "WCGAN"],
    "dcresnet-embed": TRAIN_DCRN + ["-dpm", "gc", "--conditional", "--g_label_emb_mode", "embed"],
}


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """One-epoch run directories of the port for TOOL_RUNS, and of the JAX
    package for the unconditional vanilla run ("jax-uncond")."""
    import jax
    import train as jax_train
    from csl_gan_tpu_torch import train as port_train

    root = tmp_path_factory.mktemp("tool_runs")
    common = ["-ne", "1", "--manual_seed", "2", "--save_every", "1"]
    for name, args in TOOL_RUNS.items():
        tss = args[args.index("-tss") + 1]
        port_train.main(args + common + ["--log_every", tss, "--platform", "cpu",
                                         "-o", str(root / name)])
    prev = jax.config.jax_default_prng_impl      # train.py sets rbg
    try:
        jax_train.main(TOOL_RUNS["vanilla-uncond"] + common + ["--log_every", "200",
                                                               "-o", str(root / "jax-uncond")])
    finally:
        jax.config.update("jax_default_prng_impl", prev)
    return root


@pytest.mark.parametrize("which", list(TOOL_RUNS) + ["jax-uncond"])
def test_tools_read_the_variants_saves(tool_runs, which, tmp_path, monkeypatch, capsys):
    """gensamples, temp_file and mem_inf_attack on a save of each variant,
    of either package (the JAX tools' label handling: none when
    unconditional)."""
    from csl_gan_tpu_torch import gensamples, mem_inf_attack, temp_file
    from csl_gan_tpu_torch.utils.images import read_png

    run = str(tool_runs / which)
    gensamples.main([run, "-e", "1", "-n", "5", "-bs", "3", "--platform", "cpu"])
    assert read_png(os.path.join(run, "G-1-samples", "5.png")).shape == (28, 28)
    temp_file.main([run, "-e", "1", "-d", "cpu"])
    assert "Loaded epoch 1 | D(G(z,y),y) =" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    mem_inf_attack.main(["--model_dir", str(tool_runs), "--model_name", which,
                         "--checkpoints", "1", "--asr_iters", "5", "--batch_size", "100",
                         "--compute_fid", "--num_generated_samples", "30",
                         "--train_set_size", "200", "--public_set_size", "200", "--save",
                         "--platform", "cpu"])
    with open(tmp_path / "outputs" / f"{which}.json") as f:
        entry = json.load(f)["1"]
    assert 0.0 <= entry["asr"] <= 1.0 and np.isfinite(entry["pixel_fid"])


def test_unconditional_runs_resume_across_packages(tool_runs):
    """The port continues the JAX package's unconditional run from its saves,
    and the JAX package the port's; epsilon continues either way."""
    import jax
    import train as jax_train

    def eps_rows(run):
        with open(run / "privacy_log.csv") as f:
            return [float(r["Epsilon"]) for r in csv.DictReader(f)]

    resume = ["MNIST", "-re", "1", "-ne", "2", "-ka", "n_epochs"]
    Trainer(toptions.parse(resume + ["-rp", str(tool_runs / "jax-uncond"),
                                     "--platform", "cpu"])).run()
    prev = jax.config.jax_default_prng_impl      # train.py sets rbg
    try:
        jax_train.main(resume + ["-rp", str(tool_runs / "vanilla-uncond")])
    finally:
        jax.config.update("jax_default_prng_impl", prev)
    for run in ("jax-uncond", "vanilla-uncond"):
        eps = eps_rows(tool_runs / run)
        assert len(eps) == 2 and eps[0] < eps[1], run
        assert (tool_runs / run / "saves" / "G-2").exists(), run
    assert eps_rows(tool_runs / "jax-uncond") == eps_rows(tool_runs / "vanilla-uncond")
