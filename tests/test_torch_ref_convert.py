"""The port's reference-checkpoint converter (csl_gan_tpu_torch/
convert_reference_checkpoint.py, training/ref_convert.py) and its
pixel-shuffle G against the JAX package's, on the CPU.

The upstream code is not in the repository, so the reference-format
directories are built here: the opt.txt of a JAX-parsed config without the JAX package's
extension flags (an upstream opt.txt has none of them), and torch pickles
``{epoch, model_state_dict, optimizer_state_dict, loss}`` whose keys and
shapes are the upstream ones the JAX package's key maps name (torch layouts:
Linear [out, in], Conv2d OIHW), with seeded numpy values, BatchNorm running
statistics and ``num_batches_tracked``, and Adam's state after one step.

Tolerances: both converters move the same fp32 values, so the saves are
compared byte for byte. On the converted weights both packages run the same
fp32 ops (the reference's upsampling, then a plain conv) and differ only in
summation order: G images and D outputs within 1e-5.
"""

import csv
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_reference_checkpoint as jcrc
from csl_gan_tpu import options as joptions
from csl_gan_tpu.models import common as jcommon
from csl_gan_tpu.models import dcresnet as jdcr
from csl_gan_tpu.models.registry import init_models as jinit_models
from csl_gan_tpu.training import checkpoint as jcheckpoint
from csl_gan_tpu.training import ref_convert as jrc
from csl_gan_tpu.training.steps import TrainStepBuilder
from csl_gan_tpu_torch import convert, gensamples, temp_file
from csl_gan_tpu_torch import convert_reference_checkpoint as tcrc
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models import common as tcommon
from csl_gan_tpu_torch.models import dcresnet as tdcr
from csl_gan_tpu_torch.privacy import RdpAccountant
from csl_gan_tpu_torch.tools.saved_run import load_run
from csl_gan_tpu_torch.training import ref_convert as trc
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.utils import msgpack

torch.set_num_threads(2)

SMALL = ["-tss", "100", "-bs", "50", "--manual_seed", "3"]
CASES = {
    "vanilla_acgan": ["MNIST", "--conditional"] + SMALL,
    "dcrn_gn_acgan": ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc"]
    + SMALL,
    "dcrn_bn_wcgan": ["MNIST", "--model", "DeepConvResNet", "--conditional",
                      "--conditional_arch", "WCGAN"] + SMALL,
}
# The JAX package's flags past the reference's (its options.py extensions).
EXTENSIONS = ("mesh_shape", "fsdp", "tp", "ref_pixel_shuffle", "per_sample_chunk", "platform",
              "rbg", "multihost", "coordinator_address", "num_processes", "process_id",
              "host_loop", "bf16", "poisson", "conv_ghost", "pallas", "stop_on_g_freeze",
              "bf16_table", "u8_table", "phase_gn4", "phase_carry", "phase_gn4_max_f",
              "group_fakes", "pallas_epoch")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _torch_shape(path, shape):
    if path[-1] == "kernel" and len(shape) == 4:     # HWIO -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
    if path[-1] == "kernel":                         # [in, out] -> [out, in]
        return (shape[1], shape[0])
    return tuple(shape)


def _ref_state(rng, key_map, params, stats_map=(), stats=None):
    """(upstream state dict, Adam state after one step) for a JAX key map."""
    sd, adam = {}, {}
    for i, (tk, path, _) in enumerate(key_map):
        shape = _torch_shape(path, _leaf(params, path).shape)
        if len(shape) > 1:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            v = rng.uniform(-bound, bound, shape)
        else:
            v = rng.uniform(-0.5, 0.5, shape) + (1.0 if tk.endswith("bn1.weight") or
                                                 tk.endswith("bn2.weight") or
                                                 tk == "bn.weight" else 0.0)
        sd[tk] = torch.from_numpy(v.astype(np.float32))
        g = rng.normal(0, 1e-2, shape).astype(np.float32)
        adam[i] = {"step": torch.tensor(1.0), "exp_avg": torch.from_numpy(0.1 * g),
                   "exp_avg_sq": torch.from_numpy(1e-3 * g * g)}
    for tk, path in stats_map:
        shape = _leaf(stats, path).shape
        v = rng.normal(0, 0.1, shape) if tk.endswith("mean") else rng.uniform(0.5, 1.5, shape)
        sd[tk] = torch.from_numpy(v.astype(np.float32))
        sd[tk.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(3)
    opt_sd = {"state": adam, "param_groups": [{"lr": 2e-4, "betas": (0.5, 0.999), "eps": 1e-8,
                                               "weight_decay": 0, "amsgrad": False,
                                               "params": list(range(len(key_map)))}]}
    return sd, opt_sd


def make_ref_dir(root, argv, seed, label=1, adam=True):
    """A reference-format run directory for a config; returns its path and
    the JAX-parsed options."""
    opt = joptions.parse(argv + ["-o", str(root / "jax_opt")])
    (G, gv), (D, dv) = jinit_models(opt, abstract=True)
    rng = np.random.default_rng(seed)
    ref = root / "ref"
    (ref / "saves").mkdir(parents=True)
    written = {k: v for k, v in vars(opt).items() if k not in EXTENSIONS}
    with open(ref / "opt.txt", "w") as f:
        json.dump(written, f)
    for name, key_map, params, stats_map, stats in (
            ("G", jrc.g_key_map(opt, G), gv["params"], jrc.g_stats_map(opt, G),
             gv.get("batch_stats")),
            ("D", jrc.d_key_map(opt, D), dv["params"], (), None)):
        sd, opt_sd = _ref_state(rng, key_map, params, stats_map, stats)
        torch.save({"epoch": label - 1, "model_state_dict": sd,
                    "optimizer_state_dict": opt_sd if adam else {}, "loss": 0.0},
                   ref / "saves" / f"{name}-{label}")
    return ref, opt


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Per case: the reference directory and both packages' conversions."""
    out = {}
    for i, (case, argv) in enumerate(CASES.items()):
        root = tmp_path_factory.mktemp(case)
        ref, opt = make_ref_dir(root, argv, seed=10 + i)
        jcrc.main([str(ref), "-o", str(root / "jax")])
        tcrc.main([str(ref), "-o", str(root / "port")])
        out[case] = (ref, root / "jax", root / "port", opt)
    return out


def _tree_diff(a, b, path=""):
    """The first path where two decoded msgpack trees differ, or None."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or list(a) != list(b):
            return f"{path}: keys {list(a) if isinstance(a, dict) else a} != " \
                   f"{list(b) if isinstance(b, dict) else b}"
        for k in a:
            d = _tree_diff(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        ok = (np.asarray(a).dtype == np.asarray(b).dtype
              and np.array_equal(np.asarray(a), np.asarray(b)))
        return None if ok else f"{path}: arrays differ"
    return None if a == b and type(a) is type(b) else f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", list(CASES))
def test_converters_write_the_same_saves(converted, case):
    """saves/G-1 and D-1 of the two converters are equal byte for byte (a
    differing byte must come with exactly equal decoded trees, and the test
    names the difference); the D saves carry the same accountant steps.
    opt.txt is the reference's with
    ``ref_pixel_shuffle`` set on the DCResNet, byte for byte."""
    _, jdir, tdir, opt = converted[case]
    for f in ("G-1", "D-1"):
        a = (jdir / "saves" / f).read_bytes()
        b = (tdir / "saves" / f).read_bytes()
        if a != b:
            diff = _tree_diff(msgpack.unpackb(a), msgpack.unpackb(b))
            assert diff is None, f"{f}: {diff}"
    assert (jdir / "opt.txt").read_bytes() == (tdir / "opt.txt").read_bytes()
    with open(tdir / "opt.txt") as f:
        assert json.load(f).get("ref_pixel_shuffle") == \
            (True if opt.model == "DeepConvResNet" else None)
    accs = [msgpack.unpackb((d / "saves" / "D-1").read_bytes())["accountant"]
            for d in (jdir, tdir)]
    assert accs[0] == accs[1]
    if opt.use_dp:
        assert accs[1]["steps"] == opt.train_set_size // opt.batch_size


def _jax_converted(out_dir):
    opt = joptions.load_opt(os.path.join(out_dir, "opt.txt"))
    (G, gv), (D, dv) = jinit_models(opt, abstract=True)
    state = TrainStepBuilder(opt, G, D).init_state(gv, dv)
    state, _ = jcheckpoint.load_g(os.path.join(out_dir, "saves/G-1"), state)
    state, _, _ = jcheckpoint.load_d(os.path.join(out_dir, "saves/D-1"), state)
    return opt, G, D, state


@pytest.mark.parametrize("case", list(CASES))
def test_converted_models_match_jax(converted, case):
    """The port's G (reference pixel shuffle on the DCResNet; the BatchNorm
    G in eval mode on its converted running statistics) and D on the port's
    conversion equal the JAX G and D on the JAX conversion within 1e-5."""
    _, jdir, tdir, _ = converted[case]
    opt, G, D, jstate = _jax_converted(str(jdir))
    topt, builder, tstate, _ = load_run(str(tdir), 1, "cpu")
    if topt.model == "DeepConvResNet":
        assert topt.ref_pixel_shuffle and builder.G.ResBlockUp_0.UpsampleConv_0.ref_ps
    rng = np.random.default_rng(5)
    b, n = 4, opt.n_classes
    z = rng.normal(size=(b, opt.g_latent_dim)).astype(np.float32)
    y = (np.arange(b) % n).astype(np.int32)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    variables = {"params": jstate.g_params}
    if jstate.g_batch_stats:
        variables["batch_stats"] = jstate.g_batch_stats
    want = np.asarray(G.apply(variables, z, y, train=False))
    got = builder.sample_images(tstate, torch.from_numpy(z), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5, atol=1e-5)
    if tstate.g_batch_stats:
        assert any(float(v.abs().max()) > 1e-3 for v in tstate.g_batch_stats.values())
    jout, jaux = D.apply({"params": jstate.d_params}, x, y)
    with torch.no_grad():
        tout, taux = torch.func.functional_call(
            builder.D, tstate.d_params, (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(tout.numpy().reshape(-1), np.asarray(jout).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    assert (jaux is None) == (taux is None)
    if taux is not None:
        np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-5, atol=1e-5)
    # Adam came across: count 1, moments not zero.
    assert tstate.g_count == tstate.d_count == 1
    assert any(float(v.abs().max()) > 0 for v in tstate.g_mu.values())


def test_celeba64_g_at_full_width_matches_jax(tmp_path):
    """celeba_g64 at full width (the stem's (C, 4, 4) -> (4, 4, C) permutation
    at 512 channels, four pixel-shuffle blocks): the port's conversion and G
    against the JAX package's key maps and G, within 1e-5."""
    argv = ["CelebA", "--conditional", "-dpm", "gc", "-nms", "1", "--mean_sample_size", "8",
            "-tss", "1280", "-bs", "128", "--bf16", "false"]
    opt = joptions.parse(argv + ["-o", str(tmp_path / "o")])
    opt.ref_pixel_shuffle = True
    (G, gv), _ = jinit_models(opt, init_D=False, abstract=True)
    key_map = jrc.g_key_map(opt, G)
    sd, _ = _ref_state(np.random.default_rng(3), key_map, gv["params"])
    jparams, _ = jrc.convert_model_state(sd, key_map, gv["params"])
    tG = tdcr.celeba_g64(n_classes=2, ref_ps=True)
    tparams, _ = trc.convert_model_state(sd, trc.g_key_map(opt, tG), dict(tG.state_dict()))
    # The port's conversion is the JAX one in the port's layout (convert.py).
    want_sd = convert.params_from_jax(jparams, "G")
    assert set(tparams) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(tparams[k], v), k
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, 128)).astype(np.float32)
    y = np.array([0, 1], np.int32)
    want = np.asarray(jax.jit(lambda p, z, y: G.apply({"params": p}, z, y, train=False))(
        jparams, z, y))
    with torch.no_grad():
        got = torch.func.functional_call(tG, tparams, (torch.from_numpy(z),
                                                       torch.from_numpy(y).long())).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 5, 8), (1, 4, 4, 6), (3, 7, 7, 128)])
def test_ref_pixel_shuffle_is_the_jax_function_bitwise(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = tcommon.ref_pixel_shuffle_upsample_2x(torch.from_numpy(x)).numpy()
    want = np.asarray(jcommon.ref_pixel_shuffle_upsample_2x(jnp.asarray(x)))
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel_size", [1, 5])
def test_ref_ps_upsample_conv_upsamples_first(kernel_size):
    """UpsampleConv(ref_ps=True) upsamples before the conv for the 1x1
    shortcut too, as JAX's does: under the scramble the 1x1 conv does not
    commute with the upsample, so conv-then-upsample gives other values."""
    cin, f = 8, 4
    ju = jdcr.UpsampleConv(f, kernel_size, ref_ps=True)
    x = np.random.default_rng(kernel_size).normal(size=(2, 3, 3, cin)).astype(np.float32)
    jv = ju.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tu = tdcr.UpsampleConv(cin, f, kernel_size, ref_ps=True)
    tu.load_state_dict(convert.params_from_jax(jv["params"], "G"))
    want = np.asarray(ju.apply(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tu(torch.from_numpy(x)).numpy()
        tu.ref_ps = False
        nearest = tu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(nearest - want).max() > 1e-2
    if kernel_size == 1:
        conv_first = tcommon.ref_pixel_shuffle_upsample_2x(torch.from_numpy(
            np.asarray(jdcr.TorchConv(f, 1, padding="SAME").apply(
                {"params": jv["params"]["TorchConv_0"]}, jnp.asarray(x))))).numpy()
        assert np.abs(conv_first - want).max() > 1e-2


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_a_missing_or_extra_upstream_key_raises(tmp_path, change):
    ref, _ = make_ref_dir(tmp_path, CASES["dcrn_gn_acgan"], seed=20)
    path = ref / "saves" / "D-1"
    ckpt = torch.load(path, weights_only=True)
    if change == "missing":
        del ckpt["model_state_dict"]["blocks.1.bias"]
    else:
        ckpt["model_state_dict"]["blocks.9.weight"] = torch.zeros(3)
    torch.save(ckpt, path)
    match = "missing 'blocks.1.bias'" if change == "missing" else "unmapped reference keys"
    for main in (jcrc.main, tcrc.main):
        with pytest.raises(KeyError, match=match):
            main([str(ref), "-o", str(tmp_path / main.__module__)])


def test_a_wrong_shape_raises(tmp_path):
    ref, _ = make_ref_dir(tmp_path, CASES["vanilla_acgan"], seed=21)
    path = ref / "saves" / "G-1"
    ckpt = torch.load(path, weights_only=True)
    ckpt["model_state_dict"]["lin2.bias"] = torch.zeros(5)
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match="lin2.bias"):
        tcrc.main([str(ref), "-o", str(tmp_path / "out")])


def test_load_opt_fills_the_missing_flags(converted, tmp_path):
    """The reference's opt.txt lacks the JAX package's extension flags: the
    port takes its parser's defaults for them. A per-layer vector without
    its user-set mark counts as the user's unless it is the CelebA default,
    as the JAX package reads such a file."""
    ref, _, tdir, _ = converted["dcrn_gn_acgan"]
    with open(ref / "opt.txt") as f:
        written = json.load(f)
    assert "bf16" not in written
    opt = toptions.load_opt(str(ref / "opt.txt"))
    assert (opt.bf16, opt.pallas, opt.conv_ghost, opt.platform, opt.ref_pixel_shuffle) == \
        (False, False, True, None, False)
    assert toptions.load_opt(str(tdir / "opt.txt")).ref_pixel_shuffle is True
    for vec, user_set in ((None, False), (toptions.CELEBA_DEFAULTS["clipping_param_per_layer"],
                                          False), ([1.0] * 6, True)):
        legacy = {k: v for k, v in written.items() if not k.endswith("_user_set")}
        legacy["clipping_param_per_layer"] = vec
        with open(tmp_path / "opt.txt", "w") as f:
            json.dump(legacy, f)
        got = toptions.load_opt(str(tmp_path / "opt.txt"))
        assert (got.cpl_user_set, got.issv_user_set) == (user_set, False)


def test_converted_run_resumes_and_trains(converted, tmp_path):
    """``-rp`` on a converted DCResNet run: the pixel-shuffle G trains one
    more epoch from the converted weights and Adam state, with finite logs,
    and the tools read the new saves."""
    _, _, tdir, _ = converted["dcrn_gn_acgan"]
    run = tmp_path / "run"
    shutil.copytree(tdir, run)
    opt = toptions.parse(["MNIST", "-rp", str(run), "-re", "1", "-ne", "2", "-ka", "n_epochs",
                          "train_d_until_threshold", "--train_d_until_threshold", "1e18",
                          "--platform", "cpu"])
    assert opt.ref_pixel_shuffle
    tr = Trainer(opt)
    before = {k: v.clone() for k, v in tr.state.g_params.items()}
    assert tr.start_epoch == 1 and tr.state.g_count == 1
    tr.run()
    assert tr.state.g_count > 1
    assert any(not torch.equal(before[k], v) for k, v in tr.state.g_params.items())
    assert all(bool(torch.isfinite(v).all()) for v in tr.state.g_params.values())
    # The accountant continues from the converted D save's 2 steps.
    with open(run / "privacy_log.csv") as f:
        eps = float(list(csv.reader(f))[-1][1])
    acc = RdpAccountant(opt.batch_size, opt.train_set_size, opt.sigma)
    acc.step(2 * tr.n_batches)
    assert eps == acc.get_privacy_spent(opt.delta)[0]
    gensamples.main([str(run), "-e", "2", "-n", "3", "-bs", "3", "-d", "cpu"])
    assert len(os.listdir(run / "G-2-samples")) == 3
    temp_file.main([str(run), "-e", "2", "-d", "cpu"])
