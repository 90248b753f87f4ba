"""The port's evaluation tools (python -m csl_gan_tpu_torch.<tool>) and
tools/fid.py against the JAX package's:

- ``budget_analysis`` equals JAX ``analyze`` exactly on the same opt.txt
  (MNIST gc, CelebA gc, and a tm run's zCDP ledger);
- ``frechet_distance``, ``pixel_features`` and ``calculate_fid`` match JAX
  tools/fid.py (rtol 1e-6), and ``attack`` does with the same rng;
- ``gensamples``, ``temp_file``, ``downstream`` and ``mem_inf_attack`` run
  with ``--platform cpu`` on a run directory of the port and of the JAX
  package (and ``gensamples`` on a DeepConvResNet run, through K4's plain
  version);
- Inception FID is refused, not replaced by pixel FID in silence; a tool
  without ``-d cpu`` raises when no CUDA device is visible; ``downstream``
  names scikit-learn when it is missing.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import budget_analysis as jax_budget  # noqa: E402
import mem_inf_attack as jax_mia  # noqa: E402
import train as jax_train  # noqa: E402
from csl_gan_tpu import options as joptions  # noqa: E402
from csl_gan_tpu.tools import fid as jfid  # noqa: E402
from csl_gan_tpu_torch import budget_analysis, downstream, gensamples, mem_inf_attack  # noqa: E402
from csl_gan_tpu_torch import temp_file  # noqa: E402
from csl_gan_tpu_torch import train as port_train  # noqa: E402
from csl_gan_tpu_torch.tools import fid  # noqa: E402
from csl_gan_tpu_torch.utils.images import read_png  # noqa: E402

RUN = ["MNIST", "--conditional", "-dpm", "gc", "-tss", "200", "-bs", "40", "-ne", "1",
       "--manual_seed", "2", "--log_every", "200", "--save_every", "1", "--platform", "cpu"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "-bs", "8", "-tss", "80", "--train_d_until_threshold",
        "1e18", "-ne", "1", "--log_every", "80", "--manual_seed", "4", "--platform", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run directories, one epoch each: {"port", "jax", "dcresnet"}."""
    root = tmp_path_factory.mktemp("runs")
    prev = jax.config.jax_default_prng_impl      # train.py sets rbg
    try:
        jax_train.main(RUN + ["-o", str(root / "jax")])
    finally:
        jax.config.update("jax_default_prng_impl", prev)
    port_train.main(RUN + ["-o", str(root / "port")])
    port_train.main(DCRN + ["-o", str(root / "dcresnet")])
    return {k: str(root / k) for k in ("port", "jax", "dcresnet")}


OPTS = {
    "mnist-gc": ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "10", "-bs", "600"],
    "celeba-gc": ["CelebA", "--conditional", "-dpm", "gc", "-bs", "128", "-tss", "12800", "-nms", "1"],
    "mnist-tm": ["MNIST", "-dpm", "tm", "-bs", "100", "--tm_rho_per_epoch", "3"],
}


@pytest.mark.parametrize("name", list(OPTS))
def test_budget_analysis_equals_jax(tmp_path, name, capsys):
    opt = joptions.parse(OPTS[name] + ["-o", str(tmp_path)])
    joptions.save_opt(opt, str(tmp_path / "opt.txt"))
    want = jax_budget.analyze(joptions.load_opt(str(tmp_path / "opt.txt")), 37)
    capsys.readouterr()
    budget_analysis.main([str(tmp_path), "37"])
    assert capsys.readouterr().out.strip() == str(want)


FEATS = [np.random.default_rng(s).normal(size=(200, 8)) for s in (0, 1)]


def test_fid_matches_jax():
    a = np.random.default_rng(2).random((64, 28, 28, 1)).astype(np.float32)
    b = np.clip(a + 0.3 * np.random.default_rng(3).random(a.shape), 0, 1).astype(np.float32)
    rgb = np.random.default_rng(4).random((9, 64, 64, 3)).astype(np.float32)
    for x in (a, rgb):
        np.testing.assert_allclose(fid.pixel_features(x), jfid.pixel_features(x), rtol=1e-6)
    s1, s2 = fid.activation_statistics(FEATS[0]), fid.activation_statistics(FEATS[1])
    np.testing.assert_allclose(fid.frechet_distance(*s1, *s2),
                               jfid.frechet_distance(*s1, *s2), rtol=1e-6)
    got, label = fid.calculate_fid(a, b, kind="pixel")
    want, jlabel = jfid.calculate_fid(a, b, kind="pixel")
    assert label == jlabel == "pixel_fid" and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fid_from_png_directories_matches_jax(tmp_path):
    from csl_gan_tpu.utils.images import save_image as jax_save_image
    from csl_gan_tpu_torch.utils.images import save_image

    rng = np.random.default_rng(5)
    for d, writer in (("jax", jax_save_image), ("port", save_image)):
        os.makedirs(tmp_path / d)
        for i in range(12):
            writer(rng.random((16, 16, 3)).astype(np.float32), str(tmp_path / d / f"{i}.png"))
    np.testing.assert_allclose(fid.load_images_from_dir(str(tmp_path / "jax")),
                               jfid.load_images_from_dir(str(tmp_path / "jax")), rtol=0)
    paths = (str(tmp_path / "jax"), str(tmp_path / "port"))
    got, _ = fid.calculate_fid_given_paths(paths, 5, kind="pixel")
    want, _ = jfid.calculate_fid_given_paths(paths, 5, kind="pixel")
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_attack_matches_jax():
    rng = np.random.default_rng(6)
    vt, vn = rng.random(300), rng.random(1200)
    got = [mem_inf_attack.attack(vt, vn, 0.1, np.random.default_rng(9)) for _ in range(3)]
    want = [jax_mia.attack(vt, vn, 0.1, np.random.default_rng(9)) for _ in range(3)]
    assert got == want


def test_inception_fid_is_refused(monkeypatch):
    """Inception FID without a weights file raises FileNotFoundError in both
    packages; "auto" then takes pixel features, also when
    $FID_INCEPTION_WEIGHTS names no file (the Inception path with weights:
    tests/test_torch_inception.py)."""
    x = np.zeros((4, 16, 16, 1), np.float32)
    monkeypatch.delenv("FID_INCEPTION_WEIGHTS", raising=False)
    for calc in (fid.calculate_fid, jfid.calculate_fid):
        with pytest.raises(FileNotFoundError, match="FID_INCEPTION_WEIGHTS"):
            calc(x, x, kind="inception")
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", "/some/weights.npz")
    with pytest.raises(FileNotFoundError, match="FID_INCEPTION_WEIGHTS"):
        fid.make_feature_fn("inception")
    assert fid.make_feature_fn("auto")[1] == jfid.make_feature_fn("auto")[1] == "pixel_fid"
    assert fid.calculate_fid(x, x)[1] == "pixel_fid"


@pytest.mark.parametrize("which", ["port", "jax", "dcresnet"])
def test_gensamples(runs, which):
    gensamples.main([runs[which], "-e", "1", "-n", "7", "-bs", "3", "--platform", "cpu"])
    out = os.path.join(runs[which], "G-1-samples")
    assert sorted(os.listdir(out), key=lambda f: int(f[:-4])) == [f"{i}.png" for i in range(1, 8)]
    assert read_png(os.path.join(out, "7.png")).shape == (28, 28)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_temp_file(runs, which, capsys):
    temp_file.main([runs[which], "-e", "1", "-d", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded epoch 1 | D(G(z,y),y) =" in out


@pytest.mark.parametrize("which", ["port", "jax"])
def test_downstream(runs, which):
    downstream.main([runs[which], "-e", "1", "-n", "300", "-bs", "100", "-d", "cpu"])
    with open(os.path.join(runs[which], "downstream_log.csv")) as f:
        rows = [r.strip().split(",") for r in f if r.strip()]
    assert rows[-1][0] == "1" and 0.0 <= float(rows[-1][1]) <= 1.0


@pytest.mark.parametrize("which", ["port", "jax"])
def test_mem_inf_attack(runs, which, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model_dir, model_name = os.path.split(runs[which].rstrip("/"))
    mem_inf_attack.main(["--model_dir", model_dir, "--model_name", model_name,
                         "--checkpoints", "1", "--asr_iters", "20", "--batch_size", "100",
                         "--generate_samples", "--compute_fid",
                         "--num_generated_samples", "60", "--train_set_size", "200",
                         "--public_set_size", "200", "--save", "--platform", "cpu"])
    with open(tmp_path / "outputs" / f"{model_name}.json") as f:
        entry = json.load(f)["1"]
    assert 0.0 <= entry["asr"] <= 1.0 and np.isfinite(entry["pixel_fid"])


def test_tools_raise_without_a_cuda_device(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((gensamples.main, [runs["port"], "-e", "1", "-n", "1"]),
                       (temp_file.main, [runs["port"], "-e", "1"])):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            main(argv)


def test_downstream_names_scikit_learn(runs, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"] + ["sklearn"]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="scikit-learn"):
        downstream.main([runs["port"], "-e", "1", "-d", "cpu"])
