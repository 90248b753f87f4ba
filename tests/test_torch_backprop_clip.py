"""Backprop clipping (``--backprop_clip``) of the port against the JAX
package's, on the CPU:

  - ``l2_clip`` and ``cotangent_clip`` (forward, backward, inside
    ``torch.func.vmap(grad)``, and a second-order pass through the clipped
    backward) against JAX ``ops/backprop_clip.py``;
  - ``derive_bpc`` (manual and automatic), ``mnist_vanilla_d_layers`` and
    ``bpc_config_for`` equal to JAX's;
  - the derived bounds hold on the clipped D (JAX
    tests/test_backprop_clip.py:57-87);
  - the gc and is D steps and the G step with ``bpc`` against JAX;
  - the Trainer's override of the clipping (flat and per layer) against the
    JAX Trainer's, with ``opt.txt`` keeping the flags as given;
  - the refusal on the DCResNet with the JAX message;
  - a CLI run.

Tolerances: the clip ops 1e-6 relative (fp32, one reduction); bound
numbers exactly (both packages compute them in float64 numpy); steps at
tests/test_torch_gc_step.py's bounds (params and Adam moments 2e-3 in
normalized l2, nu 4e-3, loss metrics 1e-4 relative, is_sens 1e-4); the
clipping vector 1e-7 relative (both fp32 of the same float64 values).
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from csl_gan_tpu import options as joptions
from csl_gan_tpu.ops import backprop_clip as jbpc
from csl_gan_tpu.training.loop import Trainer as JaxTrainer
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch import train as port_train
from csl_gan_tpu_torch.models import losses
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import backprop_clip as bpc
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training.loop import Trainer
from torch_conditional_cases import (BS, STEP_DCRN, STEP_VANILLA, as_t, as_y, assert_d_step,
                                     builders, l2rel)
from torch_dp_surface_cases import assert_stats, engine_pair, gc_pair

os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_clip_ops_match_jax():
    x = np.array([[3.0, 4.0], [0.3, 0.4]], np.float32)       # norms 5 and 0.5
    out = bpc.l2_clip(torch.tensor(x), 1.0).numpy()
    np.testing.assert_allclose(out, np.asarray(jbpc.l2_clip(jnp.asarray(x), 1.0)), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out[1], x[1], rtol=1e-6)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3, 4)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32) * 3
    at = torch.tensor(a, requires_grad=True)
    y = bpc.cotangent_clip(at, 0.5)
    torch.testing.assert_close(y, at, rtol=0, atol=0)
    g, = torch.autograd.grad((y * torch.tensor(w)).sum(), at)
    jg = jax.grad(lambda t: jnp.sum(jbpc.cotangent_clip(t, 0.5) * w))(jnp.asarray(a))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(g.numpy().reshape(5, -1), axis=1), 0.5, rtol=1e-5)

    # Per-sample gradients through the clip, under vmap(grad).
    p = rng.standard_normal((4, 6)).astype(np.float32)

    def tf(pp, ai):
        return torch.sum(torch.tanh(bpc.cotangent_clip(ai[None] @ pp, 0.2)) * 4.0)

    def jf(pp, ai):
        return jnp.sum(jnp.tanh(jbpc.cotangent_clip(ai[None] @ pp, 0.2)) * 4.0)
    tg = vmap(grad(tf), in_dims=(None, 0))(torch.tensor(p), torch.tensor(a))
    jgg = jax.vmap(jax.grad(jf), in_axes=(None, 0))(jnp.asarray(p), jnp.asarray(a))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jgg), rtol=1e-5, atol=1e-7)

    # A second-order pass (the is sensitivity) through the clipped backward.
    pt = torch.tensor(p, requires_grad=True)
    xt = torch.tensor(a[0], requires_grad=True)
    gp, = torch.autograd.grad(tf(pt, xt), pt, create_graph=True)
    gx, = torch.autograd.grad(gp.norm(), xt)
    jgx = jax.grad(lambda ai: jnp.linalg.norm(jax.grad(jf)(jnp.asarray(p), ai)))(
        jnp.asarray(a[0]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-7)


def test_derive_bpc_matches_jax():
    lin = [bpc.LayerSpec("linear", (10,), (4,), 40, True)]
    assert bpc.derive_bpc(lin, [2.0], [3.0]).grad_l2_bounds == [6.0, 2.0]
    conv = [bpc.LayerSpec("conv", (3, 8, 8), (5, 4, 4), 3 * 5 * 9, True),
            bpc.LayerSpec("linear", (80,), (1,), 80, False)]
    for layers in (lin, conv, bpc.mnist_vanilla_d_layers(0), bpc.mnist_vanilla_d_layers(10)):
        jl = [jbpc.LayerSpec(*vars(s).values()) for s in layers]
        for args in (([0.01] * len(layers), [20.0] * len(layers)), (None, None)):
            for scales in ((), (0.2, 1e-3)):
                got = bpc.derive_bpc(layers, *args, *scales)
                want = jbpc.derive_bpc(jl, *args, *scales)
                assert vars(got) == vars(want)
    assert [vars(s) for s in bpc.mnist_vanilla_d_layers(10)] == \
        [vars(s) for s in jbpc.mnist_vanilla_d_layers(10)]
    assert bpc.l2_size(784, 0.2) == jbpc.l2_size(784, 0.2)
    assert bpc.l2_to_l1(0.3, 25) == jbpc.l2_to_l1(0.3, 25)


@pytest.mark.parametrize("extra", [
    [], ["--conditional"], ["--bpc_back_clip_param", "0.02", "--bpc_forward_clip_param", "5"],
    ["-gcm", "constant-pl"], ["--conditional", "-gcm", "constant-pl", "--bpc_back_clip_param_pl",
                              "0.01", "0.02", "0.03", "--bpc_forward_clip_param_pl", "3", "4",
                              "5"],
    ["-bpcaas", "0.3", "-bpcawgs", "1e-4", "-gcm", "adaptive-pl", "-nms", "1",
     "--mean_sample_size", "4"],
])
def test_bpc_config_for_matches_jax(tmp_path, extra):
    argv = ["MNIST", "-dpm", "gc", "-bpc", "true", "-tss", "80", "-bs", "8"] + extra
    jopt = joptions.parse(argv + ["-o", str(tmp_path / "j")])
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")])
    assert vars(bpc.bpc_config_for(topt)) == vars(jbpc.bpc_config_for(jopt))


def test_bpc_bounds_actually_hold(tmp_path):
    """The per-sample parameter gradients of the clipped D respect the
    derived bounds (JAX tests/test_backprop_clip.py:57-87)."""
    opt = toptions.parse(["MNIST", "-bpc", "true", "-dpm", "gc", "--bpc_forward_clip_param",
                          "20", "--bpc_back_clip_param", "0.01", "--manual_seed", "1", "-bs",
                          "8", "-tss", "80", "--platform", "cpu", "-o", str(tmp_path)])
    _, D = init_models(opt, torch.device("cpu"))
    x = torch.rand(8, 28, 28, 1, generator=torch.Generator().manual_seed(0)) * 100.0
    params = {k: v.detach() for k, v in D.state_dict().items()}

    def loss_ps(p, xi):
        out, _ = torch.func.functional_call(D, p, (xi[None], None), {"bpc": True})
        return losses.d_real_loss("vanilla", out, "none")[0]
    ps = gops.per_sample_grads(loss_ps, params, x)
    cfg = bpc.bpc_config_for(opt)
    for name, bound in zip(D.state_dict(), cfg.grad_l2_bounds):      # torch order
        norms = ps[name].reshape(8, -1).norm(dim=1)
        assert float(norms.max()) <= bound * (1 + 1e-4), (name, float(norms.max()), bound)
    # Without the flag the same D is the plain one.
    out, _ = D(x)
    out_c, _ = D(x, bpc=True)
    assert not torch.allclose(out, out_c)


STEPS = {
    "gc-acgan-flat": (STEP_VANILLA + ["--conditional", "-dpm", "gc"], "gc"),
    "gc-uncond-per-layer-split": (STEP_VANILLA + ["-dpm", "gc", "-gcm", "constant-pl", "-cpl",
                                                  "0.3", "0.05", "0.2", "0.04"], "gc"),
    "gc-cgan-combined": (STEP_VANILLA + ["--conditional", "--conditional_arch", "CGAN", "-dpm",
                                         "gc", "--grad_clip_split", "false"], "gc"),
    "is-acgan": (STEP_VANILLA + ["--conditional", "-dpm", "is"], "is"),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_bpc_d_steps_match_jax(tmp_path, name):
    args, engine = STEPS[name]
    jb, st, tb, ts = builders(tmp_path, args + ["-bpc", "true", "--bpc_back_clip_param",
                                                "0.02", "--bpc_forward_clip_param", "8"])
    assert tb.use_bpc and jb.use_bpc and not tb.use_ghost
    assert (tb.D.bpc_fwd, tb.D.bpc_back) == (jb.D.bpc_fwd, jb.D.bpc_back)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32) if jb.opt.conditional else None
    if engine == "gc":
        assert tb.materialized
        st_d, jdm, new, tdm = gc_pair(jb, st, tb, ts, x, y)
        assert_stats(jdm, tdm)
    else:
        st_d, jdm, new, tdm = engine_pair(jb, st, tb, ts, "is", x, y, None, None)
        np.testing.assert_allclose(float(tdm["is_sens"]), float(jdm["is_sens"]), rtol=1e-4)
    assert_d_step(st_d, jdm, new, tdm, False)


@pytest.mark.parametrize("bpc_g", ["true", "false"])
def test_bpc_g_step_matches_jax(tmp_path, bpc_g):
    jb, st, tb, ts = builders(tmp_path, STEP_VANILLA + [
        "--conditional", "-dpm", "gc", "-bpc", "true", "--bpc_back_clip_param", "0.001",
        "--bpc_forward_clip_param", "4", "--bpc_during_g_train", bpc_g])
    g_key = jax.random.PRNGKey(17)
    st_g, jgm = jax.jit(jb._g_step)(st, g_key)
    kg = key_rows(g_key, 2)
    z, y = jb.gen_z(kg[0], BS), jb.gen_y(kg[1], BS)
    oh = torch.nn.functional.one_hot(as_y(y), 10).float()
    new, tgm = tb.g_step(ts, as_t(z), oh)
    out = convert.train_state_to_jax(new)
    h = jax.device_get(st_g)
    assert l2rel(h.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    assert l2rel(h.g_params, out["g_params"]) < 2e-3
    for k in tgm:
        np.testing.assert_allclose(float(tgm[k]), float(jgm[k]), rtol=1e-4, atol=1e-6)
    _, plain = tb.g_step(ts, as_t(z), oh)
    tb.bpc_g = not tb.bpc_g
    _, other = tb.g_step(ts, as_t(z), oh)
    # The G loss is through the clipped D's forward exactly when asked.
    assert float(plain["g_adv_loss"]) != float(other["g_adv_loss"])


@pytest.mark.parametrize("mode", ["standard", "constant-pl"])
def test_trainer_clipping_override_matches_jax(tmp_path, mode):
    """The derived bounds times the batch size become the clipping vector
    (per layer) or its norm (flat), as the JAX Trainer sets them; opt.txt
    keeps the flags as given."""
    argv = ["MNIST", "--conditional", "-dpm", "gc", "-bpc", "true", "-gcm", mode, "-bs", "8",
            "-tss", "80", "--manual_seed", "2"]
    jt = JaxTrainer(joptions.parse(argv + ["-o", str(tmp_path / "j")]))
    tr = Trainer(toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    want = np.asarray(jax.device_get(jt.state.clipping))
    got = np.asarray(tr.state.clipping, np.float32)
    assert got.shape == want.shape == ((6,) if mode != "standard" else ())
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert tr.opt.cpl_user_set and tr.opt.clipping_param == jt.opt.clipping_param
    with open(tmp_path / "t" / "opt.txt") as f:
        saved = json.load(f)
    assert saved["clipping_param_per_layer"] is None and saved["backprop_clip"]


def test_bpc_rejects_dcresnet(tmp_path):
    argv = STEP_DCRN + ["-dpm", "gc", "-bpc", "true"]
    jopt = joptions.parse(argv + ["-o", str(tmp_path / "j")])
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")])
    with pytest.raises(Exception) as want:
        jbpc.bpc_config_for(jopt)
    for fn in (bpc.bpc_config_for, Trainer):
        with pytest.raises(Exception, match="only supported for the MNIST Vanilla") as got:
            fn(topt)
        assert str(got.value) == str(want.value)


def test_bpc_cli_run(tmp_path):
    out = tmp_path / "bpc"
    port_train.main(["MNIST", "-tss", "80", "-ne", "1", "-bs", "16", "--manual_seed", "2",
                     "--log_every", "80", "-dpm", "gc", "-bpc", "true", "--platform", "cpu",
                     "-o", str(out)])
    assert (out / "saves" / "G-1").is_file()
    with open(out / "log.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k, v in row.items():
        assert np.all(np.isfinite(np.asarray(v.strip("[]").split(), np.float64))), k
    # At the derived bounds no sample is clipped.
    assert all(float(v) == 0.0 for v in row["Grads Clipped"].strip("[]").split())
