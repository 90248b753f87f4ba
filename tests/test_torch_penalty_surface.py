"""The penalties' surface of the port against the JAX package's, on the CPU:
DRAGAN and DRAGAN1, the per-sample penalty of ``-pupd false``, and
penalties on the vanilla model.

  - ``calc_penalty`` with WGAN-GP, DRAGAN and DRAGAN1 against JAX
    ``calc_penalty`` (value and parameter gradient, batch mode) and
    ``_ps_penalty_one`` against JAX's (per-sample values, per-sample
    gradient norms and their sum, under ``torch.func.vmap(grad)``), on the
    vanilla ACGAN D and the DCResNet D; DRAGAN's std over one row;
  - the ``-pupd false`` gc step against JAX ``_d_step_gc`` on MNIST
    (WGAN-GP, DRAGAN1) and the DCResNet, flat and per layer, split and
    combined, and on the fused route (K6's plain version, at sigma 0);
  - the clip bound with a large penalty (JAX tests/test_steps.py:197-240);
  - ``--penalty`` on the vanilla model: the ghost-route gc step and the
    non-private step against JAX;
  - the is, tm and sv steps with ``-pupd false`` and with DRAGAN against JAX.

Every JAX draw is recomputed from its keys and handed to the port
(tests/torch_dp_surface_cases.py). Tolerances: penalty values 1e-5
relative, parameter gradients 1e-5 in normalized l2 (fp32; the packages
differ by reduction order only); steps at tests/test_torch_gc_step.py's
bounds (params and Adam moments 2e-3 in normalized l2, nu 4e-3, loss
metrics and the penalty 1e-4 relative, clip statistics 2e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training import penalty as jpenalty
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training import penalty as tpenalty
from torch_conditional_cases import (BS, STEP_DCRN, STEP_VANILLA, as_j, as_t, as_y,
                                     assert_d_step, builders, rel)
from torch_dp_surface_cases import (assert_stats, engine_pair, gc_pair, penalty_draws,
                                    ps_penalty_draws)

os.makedirs("output", exist_ok=True)

VANILLA_PEN = STEP_VANILLA + ["--conditional", "-dpm", "gc"]
DCRN_PEN = [a for a in STEP_DCRN if a != "WGAN-GP"] + ["--conditional", "-dpm", "gc"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(dcresnet, seed, n=BS):
    rng = np.random.default_rng(seed)
    lo = -1.0 if dcresnet else 0.0
    x = rng.uniform(lo, 1, (n, 28, 28, 1)).astype(np.float32)
    fake = rng.uniform(lo, 1, (n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, fake, y


PEN_TYPES = {"dragan": ["DRAGAN"], "dragan1": ["DRAGAN1"], "mixed": ["WGAN-GP1", "DRAGAN"]}
PEN_MODELS = {"vanilla": VANILLA_PEN, "dcresnet": DCRN_PEN}


@pytest.mark.parametrize("model,types", [("vanilla", t) for t in PEN_TYPES]
                         + [("dcresnet", "dragan1"), ("dcresnet", "mixed")])
def test_penalties_match_jax(tmp_path, model, types):
    ptypes = PEN_TYPES[types]
    args = PEN_MODELS[model] + ["--penalty"] + ptypes + ["-nms", "1", "--mean_sample_size", "4"]
    jb, st, tb, ts = builders(tmp_path, args)
    assert jb.penalty_types == tb.penalty_types == ptypes
    assert tb.aux_penalty and tb.n_classes == 10
    x, fake, y = _inputs(model == "dcresnet", 3)
    key = jax.random.PRNGKey(5)

    # Batch mode: value and parameter gradient.
    def jfn(p):
        return jpenalty.calc_penalty(jb._d_apply, p, ptypes, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(fake), jnp.asarray(y), key,
                                     aux_penalty=jb.aux_penalty, n_classes=jb.n_classes)
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(st.d_params)
    val, grads = tb._penalty_grads(ts.d_params, as_t(x), as_y(y), as_t(fake),
                                   penalty_draws(key, ptypes, x.shape))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    want = convert.params_from_jax(jax.device_get(jgrad), "D")
    for k in tb.d_leaves:
        assert rel(grads[k].numpy(), want[k]) < 1e-5, k

    # Per-sample terms (-pupd false), under vmap(grad).
    keys = jax.random.split(key, BS)

    def jone(p, xi, yi, fi, ki):
        return jb._ps_penalty_one(p, xi, yi, fi, ki)

    @jax.jit
    def jper_sample(p, *batch):
        return jax.vmap(lambda *a: jone(p, *a))(*batch), \
            jgops.per_sample_grads(jone, p, *batch)
    jv, jps = jper_sample(st.d_params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(fake), keys)
    draws = ps_penalty_draws(key, ptypes, x.shape)

    def tone(p, xi, yi, fi, *d):
        return tb._ps_penalty_one(p, xi, yi, fi, d)
    tv = vmap(lambda *a: tone(ts.d_params, *a))(as_t(x), as_y(y), as_t(fake), *draws)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
    tps = gops.per_sample_grads(tone, ts.d_params, as_t(x), as_y(y), as_t(fake), *draws)
    assert rel(gops.leaf_norms(tps).numpy(), np.asarray(jgops._leaf_norms(jps))) < 1e-5
    jsum = convert.params_from_jax(jax.device_get(
        jax.tree_util.tree_map(lambda g: g.sum(0), jps)), "D")
    for k in tb.d_leaves:
        assert rel(tps[k].sum(0).numpy(), jsum[k]) < 1e-5, k


def test_dragan_per_sample_std_is_the_rows():
    """In a per-sample term the batch is one row, so DRAGAN's std is that
    row's (population) std."""
    gen = torch.Generator().manual_seed(0)
    scale = torch.tensor([1.0, 5.0, 0.1])[:, None, None, None]
    x = torch.rand(3, 4, 4, 1, generator=gen) * scale
    u = torch.rand(3, 4, 4, 1, generator=gen)
    seen = []

    def d_apply(xx, yy):
        seen.append(xx.detach())
        return xx.reshape(xx.shape[0], -1).sum(1, keepdim=True), None
    for i in range(3):
        tpenalty.dragan_penalty(d_apply, x[i:i + 1], None, u[i:i + 1])
        want = x[i] + x[i].std(correction=0) * u[i]
        torch.testing.assert_close(seen[-1][0], want, rtol=0, atol=0)
    tpenalty.dragan_penalty(d_apply, x, None, u)
    torch.testing.assert_close(seen[-1], x + x.std(correction=0) * u, rtol=0, atol=0)


PS_CASES = {
    "vanilla-wgan-gp-flat-split": VANILLA_PEN + ["--penalty", "WGAN-GP"],
    "vanilla-dragan1-per-layer-combined": STEP_VANILLA + [
        "-dpm", "gc", "--penalty", "DRAGAN1", "-gcm", "constant-pl", "-cpl", "0.3", "0.05",
        "0.2", "0.04", "--grad_clip_split", "false"],
    "dcresnet-wgan-gp-flat-split": DCRN_PEN + ["--penalty", "WGAN-GP", "--aux_loss_type",
                                               "wasserstein"],
    "dcresnet-dragan-per-layer-combined": DCRN_PEN + [
        "--conditional_arch", "CGAN", "--penalty", "DRAGAN", "-gcm", "constant-pl", "-cpl",
        "0.3", "0.05", "0.2", "0.04", "0.5", "--grad_clip_split", "false"],
    "dcresnet-wgan-gp-fused": DCRN_PEN + ["--penalty", "WGAN-GP", "--pallas", "true",
                                          "--sigma", "0"],
}


@pytest.mark.parametrize("name", list(PS_CASES))
def test_per_sample_penalty_d_step_gc_matches_jax(tmp_path, name):
    jb, st, tb, ts = builders(tmp_path, PS_CASES[name] + ["-pupd", "false"])
    assert tb.ps_pen and tb.materialized and tb.fused_route == ("fused" in name)
    dcresnet = "DeepConvResNet" in PS_CASES[name]
    x, _, y = _inputs(dcresnet, 4)
    y = y if jb.opt.conditional else None
    st_d, jdm, new, tdm = gc_pair(jb, st, tb, ts, x, y, x, y)
    assert_d_step(st_d, jdm, new, tdm, True)
    assert_stats(jdm, tdm)


def test_per_sample_penalty_is_clipped(tmp_path):
    """The penalty on sensitive data is inside the clip bound: the summed
    clipped gradient's norm is at most B * C even with a large penalty, and
    the penalty is in the per-sample norms (JAX tests/test_steps.py:197-240)."""
    c = 0.05
    _, _, tb, ts = builders(tmp_path, STEP_VANILLA + ["-dpm", "gc", "--sigma", "0", "-c", str(c),
                                                     "--penalty", "WGAN-GP", "-pupd", "false"])
    assert tb.ps_pen
    gen = torch.Generator().manual_seed(31)
    x = torch.rand(BS, 28, 28, 1, generator=gen)
    fake = tb.fakes(ts.g_params, tb.gen_z(gen, BS), None)
    draws = [torch.rand(BS, 1, 1, 1, generator=gen)]
    f, args = tb.real_ps_args(x, None, None, fake, draws)
    summed, _ = gops.clipped_grad_sum(f, ts.d_params, *args, max_norm=c)
    assert float(gops.global_norm(list(summed.values()))) <= BS * c * (1 + 1e-5)
    f0, args0 = tb.real_ps_args(x, None, None)
    _, stats0 = gops.clipped_grad_sum(f0, ts.d_params, *args0, max_norm=1e9)
    _, stats = gops.clipped_grad_sum(f, ts.d_params, *args, max_norm=1e9)
    assert float(stats.norm_mean.sum()) != float(stats0.norm_mean.sum())


VANILLA_CASES = {
    "gc-ghost-wgan-gp": (VANILLA_PEN + ["--penalty", "WGAN-GP"], "gc"),
    "gc-ghost-dragan": (VANILLA_PEN + ["--penalty", "DRAGAN"], "gc"),
    "nodp-wgan-gp1": (STEP_VANILLA + ["--conditional", "--penalty", "WGAN-GP1"], "plain"),
}


@pytest.mark.parametrize("name", list(VANILLA_CASES))
def test_vanilla_penalty_matches_jax(tmp_path, name):
    """``--penalty`` on the vanilla model, on mean-sample-like rows: the gc
    step keeps the ghost route and adds the batch penalty's gradient times
    the batch; without DP the step is the full-batch one with the penalty."""
    args, engine = VANILLA_CASES[name]
    jb, st, tb, ts = builders(tmp_path, args + ["-nms", "1", "--mean_sample_size", "4"])
    x, pen_x, y = _inputs(False, 6)
    if engine == "gc":
        assert tb.use_ghost and not tb.ps_pen and not tb.materialized
        st_d, jdm, new, tdm = gc_pair(jb, st, tb, ts, x, y, pen_x, y)
        assert_stats(jdm, tdm)
    else:
        d_key = jax.random.PRNGKey(9)
        st_d, jdm = jax.jit(jb._d_step_plain)(st, jnp.asarray(x), as_j(y), jnp.asarray(pen_x),
                                             as_j(y), d_key)
        kd = key_rows(d_key, 2)
        new, tdm = tb.d_core(ts, as_t(x), as_y(y), as_t(jb.gen_z(kd[0], BS)), False,
                             pen_x=as_t(pen_x), pen_y=as_y(y),
                             alphas=penalty_draws(kd[1], jb.penalty_types, pen_x.shape))
    assert_d_step(st_d, jdm, new, tdm, True)


ENGINE_CASES = {
    "is-vanilla-pupd-false": (STEP_VANILLA + ["--conditional", "-dpm", "is", "--penalty",
                                              "WGAN-GP", "-pupd", "false"], "is"),
    "is-vanilla-dragan": (STEP_VANILLA + ["-dpm", "is", "--penalty", "DRAGAN", "-nms", "1",
                                          "--mean_sample_size", "4"], "is"),
    "tm-vanilla-pupd-false": (STEP_VANILLA + ["-dpm", "tm", "--tm_m", "2", "--penalty",
                                              "WGAN-GP1", "-pupd", "false"], "tm"),
    "sv-dcresnet-dragan1": ([a for a in STEP_DCRN if a != "WGAN-GP"]
                            + ["-dpm", "sv", "--penalty", "DRAGAN1"], "sv"),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engines_with_the_new_penalties_match_jax(tmp_path, name):
    """Under is / tm / sv the penalty is a batch penalty: on the real batch
    under ``-pupd false`` (the JAX Trainer's ``_penalty_data``), else on
    the surrogate rows."""
    args, engine = ENGINE_CASES[name]
    jb, st, tb, ts = builders(tmp_path, args)
    assert not tb.ps_pen
    dcresnet = "DeepConvResNet" in args
    x, pen_x, y = _inputs(dcresnet, 8)
    y = y if jb.opt.conditional else None
    if "pupd-false" in name:
        pen_x = x
    st_d, jdm, new, tdm = engine_pair(jb, st, tb, ts, engine, x, y, pen_x, y)
    assert_d_step(st_d, jdm, new, tdm, True)
    if engine == "is":
        np.testing.assert_allclose(float(tdm["is_sens"]), float(jdm["is_sens"]), rtol=1e-4)
