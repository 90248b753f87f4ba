"""The port's Trainer and CLI options on the CPU (--platform cpu), at a tiny
size: one epoch writes log.csv and privacy_log.csv with finite values and
its epsilon equals the JAX package's accountant for the same steps, the
device table is the JAX package's, ``--pallas true`` on K6's plain version
is reproducible, the mean samples are the JAX Trainer's, and the port
refuses to fall back to the CPU or to ignore an unported flag. The routes of
the gc D step are in tests/test_torch_trainer_routes.py and
tests/test_torch_trainer_dcresnet.py."""

import csv
import os

import numpy as np
import pytest
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner
from torch_trainer_cases import DCRN, FLAGSHIP, STEP_RUNNER_FLAGS, TINY

# The JAX package's options.parse creates ./output with a check, then a
# create (csl_gan_tpu/options.py:623-626). Under xdist, two workers whose
# first tests both parse at the same moment race on it and one raises
# FileExistsError (tests/test_models.py::test_mnist_vanilla_shapes_and_counts
# failed so). Every worker collects every test file before it runs a test,
# so creating the directory here, at collection, removes the race.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_trainer_one_epoch_cpu(tmp_path):
    out = tmp_path / "run"
    opt = toptions.parse(TINY + ["-ne", "1", "--log_every", "160",
                                 "--platform", "cpu", "-o", str(out)])
    tr = Trainer(opt)
    assert tr.device.type == "cpu"
    assert pallas_epoch.supports(tr.builder, True, 1)
    assert tr.table.dtype == torch.bfloat16 and tr.table.shape == (160, 795)
    assert tr.run() == 0
    with open(out / "log.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss", "D Real Loss",
              "D Fake Loss", "D Real Aux Loss"):
        assert np.isfinite(float(rows[0][k])), k
    with open(out / "privacy_log.csv") as f:
        eps_rows = list(csv.DictReader(f))
    assert [int(r["Epoch"]) for r in eps_rows] == [0]
    steps = 160 // 32
    ref = JaxRdpAccountant(batch_size=32, sample_size=160, noise_multiplier=0.7)
    ref.step(steps)
    np.testing.assert_allclose(float(eps_rows[0]["Epsilon"]),
                               ref.get_privacy_spent(1e-5)[0], rtol=1e-12)
    assert tr.state.d_count == tr.state.g_count == steps
    for t in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(t).all()


def test_device_table_matches_jax(tmp_path):
    """The bf16 [x | one-hot | label] table equals the JAX package's bit for
    bit (both round to nearest even), and gather_batch splits its rows."""
    import jax.numpy as jnp
    from csl_gan_tpu import options as joptions
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    jt = JaxTrainer(joptions.parse(TINY + ["-o", str(tmp_path / "j")]))
    tt = Trainer(toptions.parse(TINY + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    jtab = np.asarray(jt._dev_data[0].astype(jnp.float32))
    np.testing.assert_array_equal(tt.table.float().numpy(), jtab)
    idx = torch.tensor([3, 0, 159])
    x, y, oh = tt.builder.gather_batch(tt.table, idx)
    assert x.shape == (3, 28, 28, 1) and x.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), tt.dataset.labels[idx.numpy()])
    np.testing.assert_array_equal(oh.numpy(), np.eye(10, dtype=np.float32)[y.numpy()])
    np.testing.assert_array_equal(x.numpy().reshape(3, -1), jtab[idx.numpy(), :784])


def test_trainer_nondp_cpu(tmp_path):
    opt = toptions.parse(["MNIST", "--conditional", "-bs", "32", "-tss", "160",
                          "-ne", "2", "--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    assert tr.accountant is None and pallas_epoch.supports(tr.builder, False, 1)
    tr.run()
    assert tr.state.d_count == 10
    assert not (tmp_path / "privacy_log.csv").exists()


@pytest.mark.parametrize("steps", [1, 100, 12345])
def test_epsilon_matches_jax_accountant(steps):
    from csl_gan_tpu_torch.privacy import RdpAccountant

    a, b = RdpAccountant(600, 60000, 10.0), JaxRdpAccountant(600, 60000, 10.0)
    a.step(steps)
    b.step(steps)
    ea, aa = a.get_privacy_spent(1e-5)
    eb, ab = b.get_privacy_spent(1e-5)
    np.testing.assert_allclose(ea, eb, rtol=1e-12)
    assert aa == ab


def test_no_platform_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = toptions.parse(TINY + ["-ne", "1", "-o", str(tmp_path)])
    assert opt.platform is None
    with pytest.raises(RuntimeError, match="--platform cpu"):
        Trainer(opt)


@pytest.mark.parametrize("extra,flag", [
    (["-dpm", "is", "--backprop_clip", "true"], "--backprop_clip"),
    (["--penalty", "WGAN-GP"], "--penalty"),
    (["--poisson", "true"], "--poisson"),
    (["-gcm", "adaptive"], "--grad_clip_mode"),
    (["-gcm", "adaptive-pl"], "--grad_clip_mode"),
    (["-wd", "0.1"], "--weight_decay"),
    (["--backprop_clip", "true"], "--backprop_clip"),
    (["--fsdp", "true"], "--fsdp"),
    (["--tp", "2"], "--tp"),
    (["--u8_table", "true"], "--u8_table"),
    (["--mesh_shape", "2"], "--mesh_shape"),
    (["--multihost", "true", "--coordinator_address", "localhost:1", "--num_processes", "1",
      "--process_id", "0"], "--multihost"),
    (["-nms", "1"], "--num_mean_samples"),
    (["-pss", "10"], "--public_set_size"),
    (["-wi", "5"], "--warmup_iter"),
    (["--host_loop", "true"], "--host_loop"),
    (["--bf16", "true"], "--bf16"),
    (["--group_fakes", "true"], "--group_fakes"),
    (["--ref_pixel_shuffle", "true"], "--ref_pixel_shuffle"),
    (["-p"], "--profile_training"),
    (["--download_mnist"], "--download_mnist"),
    (["--log_every", "32"], "--log_every"),
    (["--stop_on_g_freeze", "3"], "--stop_on_g_freeze"),
    (["--aux_loss_type", "wasserstein"], "--aux_loss_type"),
    (["-bs", "20"], "--batch_size"),
])
def test_unported_flags_raise(tmp_path, monkeypatch, extra, flag):
    """Each unported flag raises naming itself. The flags that a later slice
    ported keep their cases, which now hold the lifted behaviour: on this
    config adaptive clipping (no public data, no mean samples) and mean
    samples (the default mean size exceeds -tss) raise the JAX package's
    config error on the same argv, and so does a penalty under DP without
    either (the JAX rule of ``-pupd true``), and a wasserstein aux loss on
    the conditional vanilla model (the JAX model's error, when the models
    are built); the others parse, a batch of 20, Poisson subsampling,
    backprop clipping, ``-wd``, ``--bf16`` and ``--u8_table`` off K1's path,
    and the reference's pixel shuffle, which has no effect on the vanilla
    model: one step with it gives the params of one step without it, bit for
    bit. Each flag of the single-device surface's slice builds its Trainer,
    whose runner is K1's exactly when the gate says so and the run is not
    ``--host_loop``'s. The parallel flags parse: ``--mesh_shape 2`` asks for
    two ranks and leaves K1's gate (the JAX gate's one device), ``--fsdp``
    alone and ``--multihost`` of one process ask for one (K1's gate reads
    the world ``--multihost``'s arguments give); ``--tp 2`` on one rank is
    clamped to it (JAX ``make_mesh``) and stays on K1's path.
    ``--download_mnist`` stays on K1's path, and its Trainer fetches: with no
    mirror answering it raises the JAX package's RuntimeError and never
    trains on the synthetic set (tests/test_torch_download.py fetches)."""
    argv = TINY + extra + ["--platform", "cpu", "-o", str(tmp_path)]
    if flag not in LIFTED:
        with pytest.raises(NotImplementedError, match=flag):
            toptions.parse(argv)
        return
    if LIFTED[flag] is not None:
        from csl_gan_tpu import options as joptions
        from csl_gan_tpu.models.registry import init_models as jax_init_models
        for build in (lambda: jax_init_models(joptions.parse(TINY + extra +
                                                             ["-o", str(tmp_path)])),
                      lambda: init_models(toptions.parse(argv), torch.device("cpu"))):
            with pytest.raises(Exception, match=LIFTED[flag]) as err:
                build()
            assert not isinstance(err.value, NotImplementedError)
        return
    opt = toptions.parse(argv)
    assert toptions._k1_path(opt) == (flag not in OFF_K1)
    if flag in SURFACE:
        tr = Trainer(opt)
        assert isinstance(tr.runner, EpochsRunner) == (flag not in OFF_K1 + ("--host_loop",))
    if flag == "--download_mnist":
        from csl_gan_tpu_torch.data import mnist
        monkeypatch.setattr(mnist, "_MIRRORS", ((tmp_path / "no_mirror").as_uri() + "/",))
        data = tmp_path / "data"
        with pytest.raises(RuntimeError, match="--download_mnist") as err:
            Trainer(toptions.parse(argv + ["-d", str(data)]))
        assert "no_mirror/train-images-idx3-ubyte.gz" in str(err.value)
        assert os.listdir(data / "MNIST" / "raw") == []
    if flag == "--ref_pixel_shuffle":
        states = []
        for tag, args in (("with", argv), ("without", TINY + ["--platform", "cpu"])):
            tr = Trainer(toptions.parse(args + ["-tss", "64", "-ne", "1",
                                                "-o", str(tmp_path / tag)]))
            tr.run()
            assert tr.state.d_count == tr.state.g_count == 1
            states.append(tr.state)
        for a, b in ((states[0].d_params, states[1].d_params),
                     (states[0].g_params, states[1].g_params)):
            assert all(torch.equal(a[k], b[k]) for k in b)


# Flags of test_unported_flags_raise that later slices ported, each with the
# JAX package's config error on its case, or None where the case parses.
LIFTED = {"--grad_clip_mode": "Adaptive clipping derives its thresholds",
          "--num_mean_samples": r"mean_sample_size \(5000\) exceeds", "--public_set_size": None,
          "--warmup_iter": None, "--stop_on_g_freeze": None, "--batch_size": None,
          "--penalty": "In order to enable gradient penalty using public data",
          "--poisson": None, "--backprop_clip": None, "--ref_pixel_shuffle": None,
          "--weight_decay": None, "--u8_table": None, "--host_loop": None, "--bf16": None,
          "--group_fakes": None, "--profile_training": None, "--log_every": None,
          "--aux_loss_type": "Cross entropy loss is the only aux loss supported for vanilla",
          "--fsdp": None, "--mesh_shape": None, "--multihost": None, "--tp": None,
          "--download_mnist": None}
# The lifted cases that parse but leave K1's gate.
OFF_K1 = ("--batch_size", "--poisson", "--backprop_clip", "--weight_decay", "--bf16",
          "--u8_table", "--mesh_shape")
# The flags of the single-device surface's slice.
SURFACE = ("--weight_decay", "--u8_table", "--host_loop", "--bf16", "--group_fakes",
           "--profile_training", "--log_every")


def test_pallas_true_on_the_cpu_is_reproducible(tmp_path):
    """--pallas true on CPU tensors takes K6's plain version; the Philox
    stream is a function of the drawn seeds, so one seed gives one result."""
    args = STEP_RUNNER_FLAGS["pallas-combined"][0] + ["-ne", "1", "--log_every", "160", "--platform", "cpu"]
    runs = []
    for tag, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        tr = Trainer(toptions.parse(args + ["--manual_seed", seed, "-o", str(tmp_path / tag)]))
        tr.run()
        runs.append(tr.state.d_params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert any(not torch.equal(runs[0][k], runs[2][k]) for k in runs[0])


def test_not_ported_names_only_unported_flags():
    """Nothing is left outside the port: the refusal list is gone, the
    port's parser takes every option of the JAX package's, and no module of
    the port refuses anything as not ported (``NotImplementedError`` with
    "not ported" in its message) or by a flag's name. The flags of
    STEP_RUNNER_FLAGS, the conditional variants and every later slice run
    on one device, on the data axis and on the tensor axis."""
    import ast
    import pathlib

    from csl_gan_tpu import options as joptions

    assert not hasattr(toptions, "_NOT_PORTED")

    def options_of(parser):
        return {o for a in parser._actions for o in a.option_strings}
    port = options_of(toptions.build_parser())
    assert options_of(joptions.build_parser()) <= port
    for lifted in ("--pallas", "--per_sample_chunk", "--grad_clip_split", "--conv_ghost",
                   "--clipping_param_per_layer", "--n_d_steps", "--train_d_until_threshold",
                   "--resume_path", "--dp_mode", "--conditional_arch", "--g_label_emb_mode",
                   "--public_set_size", "--warmup_iter", "--stop_on_g_freeze", "--batch_size",
                   "--num_mean_samples", "--poisson", "--backprop_clip", "--penalty",
                   "--ref_pixel_shuffle", "--weight_decay", "--group_fakes", "--u8_table",
                   "--host_loop", "--bf16", "--profile_training", "--log_every",
                   "--sample_every", "--aux_loss_type", "--fsdp",
                   "--mesh_shape", "--multihost", "--tp", "--download_mnist"):
        assert lifted in port, lifted
    root = pathlib.Path(toptions.__file__).parent
    refusals = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Raise) and node.exc is not None:
                text = ast.unparse(node.exc)
                if "NotImplementedError" in text and ("not ported" in text or "--" in text):
                    refusals.append(f"{path.relative_to(root)}:{node.lineno}")
    assert refusals == []


def test_celeba_vanilla_is_the_jax_error(tmp_path):
    """``CelebA --model Vanilla`` parses in both packages, and building its
    models raises the JAX package's config error, not a refusal."""
    from csl_gan_tpu import options as joptions
    from csl_gan_tpu.models.registry import init_models as jax_init_models
    args = ["CelebA", "--model", "Vanilla", "-tss", "128", "-o", str(tmp_path)]
    for build in (lambda: jax_init_models(joptions.parse(args)),
                  lambda: init_models(toptions.parse(args + ["--platform", "cpu"]),
                                      torch.device("cpu"))):
        with pytest.raises(Exception, match="No vanilla architecture for CelebA") as err:
            build()
        assert not isinstance(err.value, NotImplementedError)


def test_celeba_raises(tmp_path):
    """The CelebA flagship parses with the CelebA defaults, and so do its
    unconditional, CGAN, WCGAN and embedded-G variants and the reference's
    pixel shuffle (its G upsamples so in every block); CelebA
    configurations outside the ported slice raise naming the flag, and
    ``--poisson`` outside gc raises the JAX package's config error in both
    packages."""
    opt = toptions.parse(FLAGSHIP + ["-o", str(tmp_path / "ok")])
    assert (opt.model, opt.n_d_steps, opt.penalty, opt.aux_loss_type) == \
        ("DeepConvResNet", 5, ["WGAN-GP"], "wasserstein")
    assert (opt.adam_b1, opt.adam_b2, opt.sigma, opt.clipping_param) == (0.0, 0.9, 0.5, 200)
    assert opt.train_d_until_threshold == 1e18 and opt.bf16
    for variant in ([], ["--conditional", "--conditional_arch", "CGAN"],
                    ["--conditional", "--conditional_arch", "WCGAN"],
                    ["--conditional", "--g_label_emb_mode", "embed"]):
        toptions.parse(["CelebA", "-tss", "12800", "-dpm", "gc", "-nms", "1"] + variant
                       + ["-o", str(tmp_path / "ok")])
    opt = toptions.parse(["CelebA", "-tss", "12800", "--conditional", "-dpm", "gc", "-nms", "1",
                          "--ref_pixel_shuffle", "true", "-o", str(tmp_path / "ok")])
    G, _ = init_models(opt, torch.device("cpu"))
    assert all(getattr(G, f"ResBlockUp_{i}").UpsampleConv_0.ref_ps for i in range(G.n_blocks))
    # Lifted since: they parse, and the JAX package's options say the same.
    from csl_gan_tpu import options as joptions
    for extra, flag in ((["--conditional", "-dpm", "gc", "-nms", "1", "--conditional_arch",
                          "WCGAN", "--u8_table", "true"], "u8_table"),
                        (["--conditional", "-dpm", "gc", "-nms", "1", "-wd", "0.1"],
                         "weight_decay"),
                        (["--conditional", "-dpm", "gc", "-nms", "1", "--group_fakes", "true"],
                         "group_fakes")):
        args = ["CelebA", "-tss", "12800"] + extra + ["-o", str(tmp_path / "no")]
        opt, jopt = toptions.parse(args), joptions.parse(args)
        assert getattr(opt, flag) == getattr(jopt, flag) and getattr(opt, flag)
        assert opt.n_d_steps == 5 and not toptions._k1_path(opt)
    argv = ["CelebA", "-tss", "12800", "--conditional", "-dpm", "is", "-nms", "1",
            "--poisson", "true", "-o", str(tmp_path / "no")]
    for parse in (joptions.parse, toptions.parse):
        with pytest.raises(Exception, match="--poisson") as err:
            parse(argv)
        assert not isinstance(err.value, NotImplementedError)


def test_mean_samples_match_jax(tmp_path):
    """The Trainer's mean samples (the penalty's surrogate data) and their
    privacy cost equal the JAX Trainer's on the same dataset and seeds."""
    from csl_gan_tpu import options as joptions
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    jt = JaxTrainer(joptions.parse(DCRN + ["-o", str(tmp_path / "j")]))
    tt = Trainer(toptions.parse(DCRN + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    want = jt.mean_sampler.mean_samples
    assert tt.mean_sampler.mean_samples.shape == want.shape == (10, 1, 28, 28, 1)
    np.testing.assert_array_equal(tt.mean_sampler.mean_samples, want)
    np.testing.assert_allclose(tt.mean_sample_privacy_cost, jt.mean_sample_privacy_cost,
                               rtol=1e-12)

