"""One whole gc D step of the port (training/steps.py ``d_step_gc``) against
the JAX package's ``_d_step_gc``, on the CPU, for the routes beside the
flagships' own (tests/test_torch_epoch.py, tests/test_torch_celeba_step.py):

  - MNIST vanilla, ``--grad_clip_split false`` (real and fake clipped together);
  - MNIST vanilla, split, ``--per_sample_chunk 3`` with batch 8 (the chunked
    sum with a zero-padded last chunk);
  - MNIST vanilla, ``-gcm constant-pl -cpl ...`` (per-leaf thresholds and noise
    stds on the ghost route) and the same with ``--grad_clip_split false``
    (on the materialized route);
  - MNIST DCResNet, ``--conv_ghost false``: fp32 (the two-pass route) and
    ``--bf16 true`` (one pass over fp32 per-sample gradients).

Off its accelerator the JAX step takes its unfused sum and
``add_gaussian_noise`` (steps.py:740-741), so every JAX draw is recomputed
from the step's keys and handed to the port: z (key row 0), the per-leaf
noise (row 1), the penalty's interpolation weights (row 2).

Tolerances. fp32: the packages differ by reduction order only; params, Adam
moments and metrics are held to < 2e-3 in normalized l2, the bound of
tests/test_torch_celeba_step.py. bf16: the packages round activations at
other places (about one bf16 ulp on some elements), and on this model each
package's own bf16 gradients differ from its fp32 ones by up to 4.5e-2 (D) in
normalized l2, so D's moments are held to 1e-1 (mu) and 2e-1 (nu) and D's
params, which the first Adam step (b1 = 0) moves by lr times the sign of the
gradient, to 2e-2, exactly as that test holds the conv-ghost step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8
MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-c", "0.5",
         "-bs", str(BS), "-tss", "80", "--manual_seed", "5"]
CPL = ["-gcm", "constant-pl", "-cpl", "0.3", "0.05", "0.2", "0.04", "0.25", "0.06"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-c", "0.05", "-bs", str(BS),
        "-tss", "80", "--train_d_until_threshold", "1e18", "--manual_seed", "5",
        "--conv_ghost", "false"]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


CASES = {
    "mnist-combined": (MNIST + ["--grad_clip_split", "false"], "materialized"),
    "mnist-chunk3": (MNIST + ["--per_sample_chunk", "3"], "materialized"),
    "mnist-per-layer-ghost": (MNIST + CPL, "ghost"),
    "mnist-per-layer-combined": (MNIST + CPL + ["--grad_clip_split", "false"], "materialized"),
    "dcresnet-two-pass": (DCRN, "two_pass"),
    "dcresnet-bf16-one-pass": (DCRN + ["--bf16", "true"], "materialized"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_d_step_gc_matches_jax(tmp_path, name):
    args, route = CASES[name]
    bf16, dcresnet = "--bf16" in args, "DeepConvResNet" in args
    jopt = options.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)

    rng = np.random.default_rng(2)
    lo = -1.0 if dcresnet else 0.0
    x = rng.uniform(lo, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if dcresnet else None
    jpen = (jnp.asarray(pen_x), jnp.asarray(y)) if dcresnet else (None, None)

    d_key = jax.random.PRNGKey(31)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), jnp.asarray(y), *jpen,
                                       jnp.asarray(x), jnp.asarray(y), d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    noise_tree = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, jb.sigma, st.clipping, per_layer=jb.per_layer)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))

    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert {"ghost": tb.use_ghost, "two_pass": tb.use_two_pass,
            "materialized": tb.materialized}[route]
    assert (tb.use_ghost, tb.use_two_pass, tb.use_conv_ghost) == \
        (jb.use_ghost, jb.use_two_pass, jb.use_conv_ghost) and not tb.fused_route
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping)
    # The port resolves -cpl (torch order) into the same leaf-order vector.
    assert ts.clipping == pytest.approx(tb.init_state().clipping)
    assert isinstance(ts.clipping, tuple) == jb.per_layer
    yt = torch.tensor(y, dtype=torch.int64)
    noise = [noise_tree[k] for k in tb.d_leaves]
    pen = dict(pen_x=_t(pen_x), pen_y=yt, alphas=[_t(alpha)]) if dcresnet else {}
    ts, tdm = tb.d_step_gc(ts, _t(x), yt, _t(z), noise=noise, **pen)
    out = convert.train_state_to_jax(ts)

    host_d = jax.device_get(st_d)
    assert float(np.mean(np.asarray(jdm["frac_clipped"]))) > 0.5
    p_tol, mu_tol = (2e-2, 1e-1) if bf16 else (2e-3, 2e-3)
    assert _l2rel(host_d.d_params, out["d_params"]) < p_tol
    assert _l2rel(host_d.d_opt_state[0].mu, out["d_adam"][0]) < mu_tol
    assert _l2rel(host_d.d_opt_state[0].nu, out["d_adam"][1]) < 2 * mu_tol
    assert int(host_d.d_opt_state[0].count) == out["d_adam"][2] == 1
    np.testing.assert_array_equal(out["clipping"], np.asarray(host_d.clipping))

    rtol = 5e-2 if bf16 else 1e-4
    keys = ["d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss"]
    for k in keys + (["penalty"] if dcresnet else []):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)
    for k in ("d_real_acc", "d_fake_acc", "d_real_aux_acc"):
        assert abs(float(tdm[k]) - float(jdm[k])) < (100.0 / BS + 1e-3 if bf16 else 1e-3), k
    for k in ("norm_mean", "norm_std", "norm_max"):
        assert _l2rel(np.asarray(jdm[k]), tdm[k].numpy()) < (2e-2 if bf16 else 2e-3), k
    np.testing.assert_allclose(tdm["frac_clipped"].numpy(), np.asarray(jdm["frac_clipped"]),
                               atol=(1.0 / BS + 1e-6 if bf16 else 1e-6))


def test_d_step_gc_refuses_the_wrong_noise(tmp_path):
    """Per-leaf noise off the fused route, fused noise on it, never both."""
    for extra, fused_route in (([], False), (["--pallas", "true", "--grad_clip_split", "false"],
                                             True)):
        opt = toptions.parse(MNIST + extra + ["--platform", "cpu", "-o", str(tmp_path)])
        G, D = init_models(opt, torch.device("cpu"))
        b = StepBuilder(opt, G, D)
        assert b.fused_route == fused_route
        st = b.init_state()
        leaves = [st.d_params[k] for k in b.d_leaves]
        gen = torch.Generator().manual_seed(1)
        x, y = torch.rand(BS, 28, 28, 1), torch.randint(0, 10, (BS,))
        z = b.gen_z(gen, BS)
        noise = gops.noise_like(gen, leaves, 0.35)
        fused = gops.draw_fused_noise(gen, leaves, torch.full((len(leaves),), 0.35))
        good, bad = (dict(fused=fused), dict(noise=noise)) if fused_route else \
            (dict(noise=noise), dict(fused=fused))
        new, m = b.d_step_gc(st, x, y, z, **good)
        assert new.d_count == 1 and torch.isfinite(m["d_adv_loss"])
        for kw in (bad, {}, dict(noise=noise, fused=fused)):
            with pytest.raises(ValueError, match="fused"):
                b.d_step_gc(st, x, y, z, **kw)
