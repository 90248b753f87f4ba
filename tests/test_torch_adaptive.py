"""Adaptive clipping (``-gcm adaptive`` / ``adaptive-pl``) of the port against
the JAX package's, on the CPU:

  - ``StepBuilder.adaptive_clipping`` against JAX ``_adaptive_clipping`` on
    the same params and public batch: the vanilla D (materialized
    per-sample gradients) and the MNIST DCResNet D (the conv-ghost norms,
    ``norms_only``), each as ACGAN, CGAN, WCGAN and unconditional, flat and
    per layer, with the mean and the max statistic;
  - the same on the DCResNet under ``--bf16 true``;
  - one adaptive ``d_step_gc`` against JAX ``_d_step_gc`` with the JAX draws
    injected (z, the noise as unit normals, the penalty's weights), on the
    ghost, materialized, conv-ghost and two-pass routes: the new thresholds,
    params, moments and metrics;
  - the JAX package's ``test_adaptive_clipping_updates_state`` case.

Tolerances. fp32: the thresholds within 1e-5 relative (the packages differ
by reduction order only, ~1e-7 on these sizes); the step at
tests/test_torch_gc_step.py's bounds (params and moments 2e-3 in normalized
l2, nu 4e-3; loss metrics 1e-4 relative). bf16: the forward and the input
backprop run in bf16, and each package rounds at other places. The witness
is the JAX package's own bf16 thresholds against its fp32 ones (1.5e-4 to
3.1e-3 relative on these cases), and the port's bf16 thresholds are held
to 3x that gap from the JAX bf16 ones, the factor of chip_smoke.py's bf16
step checks (measured: 0.2x to 2.3x; a wrong layer moves them by O(1)).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import grads as gops
from torch_conditional_cases import (BS, STEP_DCRN, STEP_VANILLA, as_j, as_t, as_y,
                                     assert_d_step, builders, l2rel, rel)

os.makedirs("output", exist_ok=True)

ARCHS = {"acgan": ["--conditional"], "cgan": ["--conditional", "--conditional_arch", "CGAN"],
         "wcgan": ["--conditional", "--conditional_arch", "WCGAN"], "uncond": []}
MODELS = {"vanilla": STEP_VANILLA + ["-nms", "1", "--mean_sample_size", "4"],
          "dcresnet": STEP_DCRN}


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _public_batch(conditional, seed=7):
    rng = np.random.default_rng(seed)
    ax = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    ay = rng.integers(0, 10, BS).astype(np.int32) if conditional else None
    return ax, ay


def _thresholds(tmp_path, args):
    jb, st, tb, ts = builders(tmp_path, args)
    assert tb.adaptive and tb.per_layer == jb.per_layer
    assert (tb.use_conv_ghost, tb.adaptive_stat, tb.adaptive_scalar) == \
        (jb.use_conv_ghost, jb.adaptive_stat, jb.adaptive_scalar)
    ax, ay = _public_batch(jb.opt.conditional)
    want = np.asarray(jax.jit(jb._adaptive_clipping)(st.d_params, jnp.asarray(ax), as_j(ay)))
    got = tb.adaptive_clipping(ts.d_params, as_t(ax), as_y(ay))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape == ((len(tb.d_leaves),) if tb.per_layer else ())
    return got.numpy(), want


@pytest.mark.parametrize("stat", ["mean", "max"])
@pytest.mark.parametrize("mode", ["adaptive", "adaptive-pl"])
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("model", list(MODELS))
def test_adaptive_clipping_matches_jax(tmp_path, model, arch, mode, stat):
    args = MODELS[model] + ARCHS[arch] + ["-dpm", "gc", "-gcm", mode, "--adaptive_stat", stat,
                                          "-as", "1.25"]
    got, want = _thresholds(tmp_path, args)
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch,mode,stat", [("acgan", "adaptive", "mean"),
                                            ("cgan", "adaptive", "max"),
                                            ("wcgan", "adaptive-pl", "max"),
                                            ("uncond", "adaptive-pl", "mean")])
def test_adaptive_clipping_bf16_matches_jax(tmp_path, arch, mode, stat):
    args = STEP_DCRN + ARCHS[arch] + ["-dpm", "gc", "-gcm", mode, "--adaptive_stat", stat]
    got, want = _thresholds(tmp_path / "bf16", args + ["--bf16", "true"])
    _, want32 = _thresholds(tmp_path / "fp32", args)
    witness = rel(want, want32)
    assert 0 < witness < 2e-2
    assert rel(got, want) <= 3 * witness, (rel(got, want), witness)


# The adaptive gc step on each route, with the builder flag the route sets.
STEP_ROUTES = {
    "vanilla-ghost": (MODELS["vanilla"] + ARCHS["acgan"] + ["-gcm", "adaptive"], "use_ghost"),
    "vanilla-ghost-pl": (MODELS["vanilla"] + ARCHS["uncond"] + ["-gcm", "adaptive-pl",
                                                                "--adaptive_stat", "max"],
                         "use_ghost"),
    "vanilla-materialized": (MODELS["vanilla"] + ARCHS["cgan"]
                             + ["-gcm", "adaptive", "--grad_clip_split", "false"],
                             "materialized"),
    "dcresnet-conv-ghost": (STEP_DCRN + ARCHS["acgan"] + ["-gcm", "adaptive"], "use_conv_ghost"),
    "dcresnet-conv-ghost-pl": (STEP_DCRN + ARCHS["wcgan"] + ["-gcm", "adaptive-pl"],
                               "use_conv_ghost"),
    "dcresnet-two-pass": (STEP_DCRN + ARCHS["uncond"] + ["-gcm", "adaptive", "--conv_ghost",
                                                         "false"], "use_two_pass"),
}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_adaptive_d_step_gc_matches_jax(tmp_path, route):
    args, flag = STEP_ROUTES[route]
    dcresnet = "DeepConvResNet" in args
    jb, st, tb, ts = builders(tmp_path, args + ["-dpm", "gc"])
    assert getattr(tb, flag) and tb.adaptive and not tb.fused_route
    cond = jb.opt.conditional
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32) if cond else None
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    ax, ay = _public_batch(cond)
    pen = (jnp.asarray(pen_x), as_j(y)) if dcresnet else (None, None)
    d_key = jax.random.PRNGKey(31)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), as_j(y), *pen, jnp.asarray(ax),
                                       as_j(ay), d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    # add_gaussian_noise with std 1: the step's N(0, 1) draws, which the port
    # scales by its own thresholds.
    unit = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, 1.0, 1.0, per_layer=False)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))
    tpen = dict(pen_x=as_t(pen_x), pen_y=as_y(y), alphas=[as_t(alpha)]) if dcresnet else {}
    new, tdm = tb.d_step_gc(ts, as_t(x), as_y(y), as_t(z), noise=[unit[k] for k in tb.d_leaves],
                            ax=as_t(ax), ay=as_y(ay), **tpen)
    want_c = np.asarray(jax.device_get(st_d.clipping))
    assert isinstance(new.clipping, torch.Tensor) and new.clipping.shape == want_c.shape
    np.testing.assert_allclose(new.clipping.numpy(), want_c, rtol=1e-5)
    np.testing.assert_allclose(tdm["clipping"].numpy(), np.asarray(jdm["clipping"]), rtol=1e-5)
    tdm["clipping"] = torch.tensor(np.asarray(jdm["clipping"]))
    out = assert_d_step(st_d, jdm, new, tdm, dcresnet)
    np.testing.assert_allclose(out["clipping"], want_c, rtol=1e-5)
    for k in ("norm_mean", "norm_std", "norm_max"):
        assert l2rel(np.asarray(jdm[k]), tdm[k].numpy()) < 2e-3, k
    np.testing.assert_allclose(tdm["frac_clipped"].numpy(), np.asarray(jdm["frac_clipped"]),
                               atol=1e-6)


def test_adaptive_fused_step_scales_by_the_new_thresholds(tmp_path):
    """On the fused route (K6's plain version on the CPU) the step replaces
    the draw's stds with sigma times its new thresholds: the same seeds give
    the sum of the step without noise plus that much noise."""
    args = MODELS["vanilla"] + ARCHS["acgan"] + ["-dpm", "gc", "-gcm", "adaptive-pl",
                                                 "--pallas", "true", "--grad_clip_split",
                                                 "false"]
    _, _, tb, ts = builders(tmp_path, args)
    assert tb.fused_route and tb.adaptive
    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand(BS, 28, 28, 1, generator=gen), torch.randint(0, 10, (BS,), generator=gen)
    ax, ay = torch.rand(BS, 28, 28, 1, generator=gen), torch.randint(0, 10, (BS,), generator=gen)
    z = tb.gen_z(gen, BS)
    leaves = [ts.d_params[k] for k in tb.d_leaves]
    fused = gops.draw_fused_noise(gen, leaves, None)
    new, m = tb.d_step_gc(ts, x, y, z, fused=fused, ax=ax, ay=ay)
    c = tb.adaptive_clipping(ts.d_params, ax, ay)
    torch.testing.assert_close(new.clipping, c, rtol=0, atol=0)
    torch.testing.assert_close(m["clipping"], c, rtol=0, atol=0)
    tb.sigma = 0.0
    quiet, _ = tb.d_step_gc(ts, x, y, z, fused=fused, ax=ax, ay=ay)
    assert any(not torch.equal(new.d_mu[k], quiet.d_mu[k]) for k in tb.d_leaves)


def test_adaptive_clipping_updates_state(tmp_path):
    """The JAX package's case (tests/test_steps.py:116-125) on the port: the
    state's thresholds become data-dependent (the per-layer statistic times
    1.5), positive, and stay a tensor on the params' device."""
    args = ["MNIST", "-dpm", "gc", "-gcm", "adaptive-pl", "--conditional", "-nms", "1",
            "--mean_sample_size", "10", "-bs", str(BS), "-tss", "80", "--manual_seed", "5"]
    _, _, tb, ts = builders(tmp_path, args)
    ts = tb.init_state()
    before = ts.clipping.clone()
    assert isinstance(before, torch.Tensor) and before.shape == (len(tb.d_leaves),)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, (BS, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, BS))
    gen = torch.Generator().manual_seed(10)
    noise = gops.unit_normals(gen, [ts.d_params[k] for k in tb.d_leaves])
    s2, _ = tb.d_step_gc(ts, x, y, tb.gen_z(gen, BS), noise=noise, ax=x, ay=y)
    assert not torch.allclose(s2.clipping, before)
    assert bool((s2.clipping > 0).all()) and s2.clipping.device == x.device

