"""The port's gc step math for unconditional runs and the CGAN and WCGAN
variants against the JAX package's, on the CPU (the other D steps and the G
steps: tests/test_torch_conditional_engines.py):

  - the conv-ghost real pass (ops/conv_ghost.py ``dcresnet_real_ghost``) on
    the MNIST DCResNet D: unconditional, CGAN's one-hot input planes and the
    WCGAN head, at C = 0.05 (every row clipped) and C = 1e6 (none), as
    tests/test_conv_ghost.py:68-79 holds the JAX pass;
  - one ``d_step_gc`` on the ghost (vanilla), conv-ghost, two-pass and
    materialized routes against JAX ``_d_step_gc``.

Every JAX draw is recomputed from the step's keys and handed to the port, as
tests/test_torch_gc_step.py does: z (key row 0), the noise (row 1), the
penalty's interpolation weights (row 2).

Tolerances, those of tests/test_torch_gc_step.py and
tests/test_torch_dp_modes.py (all fp32; the packages differ by reduction
order only): params and Adam moments after a step within 2e-3 in normalized
l2 (nu 4e-3), loss metrics and the penalty within 1e-4 relative,
accuracies within 1e-3 (percent), clip norms 2e-3; the conv-ghost pass
within 1e-4 in normalized l2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import conv_ghost as jcg
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import conv_ghost as tcg
from torch_conditional_cases import (BS, STEP_DCRN, STEP_VANILLA, VARIANTS, as_j, as_t, as_y,
                                     assert_d_step, batch, builders, l2rel, rel)

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------- the conv-ghost real pass ----------------

@pytest.mark.parametrize("clip", [0.05, 1e6])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dcresnet_real_ghost_matches_jax(tmp_path, variant, clip):
    jopt = options.parse(STEP_DCRN + ["-dpm", "gc"] + VARIANTS[variant] + ["-o", str(tmp_path)])
    _, (D, Dv) = jax_init_models(jopt, init_G=False)
    params = jax.device_get(Dv["params"])
    x, y, _ = batch(jopt, True, 0)
    n = jopt.n_classes if jopt.conditional else 0
    planes = jopt.conditional and jopt.conditional_arch != "ACGAN"
    want, w_stats, (w_out, w_aux) = jcg.dcresnet_real_ghost(
        params, jnp.asarray(x), as_j(y), n_classes=n, arch=jopt.conditional_arch,
        aux_type=jopt.aux_loss_type, aux_scalar=1.0, row_w=None, concat_planes=planes,
        max_norm=clip, per_layer=False)
    got, g_stats, (g_out, g_aux) = tcg.dcresnet_real_ghost(
        convert.params_from_jax(params, "D"), as_t(x), as_y(y), n_classes=n,
        arch=jopt.conditional_arch, aux_type=jopt.aux_loss_type, aux_scalar=1.0, row_w=None,
        max_norm=clip, concat_planes=planes)
    assert float(np.mean(np.asarray(w_stats.frac_clipped))) == (1.0 if clip < 1 else 0.0)
    got_tree = convert.params_to_jax(got, "D")
    assert jax.tree_util.tree_structure(got_tree) == jax.tree_util.tree_structure(want)
    for (path, a), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got_tree)[0]):
        assert rel(g, a) < 1e-4, (jax.tree_util.keystr(path), rel(g, a))
    for name in ("norm_mean", "norm_std", "norm_max", "frac_clipped"):
        assert rel(getattr(g_stats, name).numpy(), getattr(w_stats, name)) < 1e-4, name
    assert rel(g_out.numpy(), w_out) < 1e-4
    assert (g_aux is None) == (w_aux is None) == (variant != "wcgan")
    if w_aux is not None:
        assert rel(g_aux.numpy(), w_aux) < 1e-4
        np.testing.assert_allclose(g_out.numpy()[:, 0], g_aux.numpy()[np.arange(BS), y])


# ---------------- the gc D step on every route ----------------

ROUTES = {
    "ghost": (STEP_VANILLA, [], "use_ghost"),
    "materialized": (STEP_VANILLA, ["--grad_clip_split", "false"], "materialized"),
    "conv-ghost": (STEP_DCRN, [], "use_conv_ghost"),
    "two-pass": (STEP_DCRN, ["--conv_ghost", "false"], "use_two_pass"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("route", list(ROUTES))
def test_d_step_gc_matches_jax(tmp_path, route, variant):
    base, extra, flag = ROUTES[route]
    dcresnet = base is STEP_DCRN
    args = base + ["-dpm", "gc"] + extra + VARIANTS[variant]
    jb, st, tb, ts = builders(tmp_path, args)
    assert getattr(tb, flag) and not tb.fused_route
    assert (tb.use_ghost, tb.use_two_pass, tb.use_conv_ghost) == \
        (jb.use_ghost, jb.use_two_pass, jb.use_conv_ghost)
    x, y, pen_x = batch(jb.opt, dcresnet, 2)
    pen = (jnp.asarray(pen_x), as_j(y)) if dcresnet else (None, None)
    d_key = jax.random.PRNGKey(31)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), as_j(y), *pen, jnp.asarray(x), as_j(y),
                                       d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    noise = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, jb.sigma, st.clipping, per_layer=jb.per_layer)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))
    tpen = dict(pen_x=as_t(pen_x), pen_y=as_y(y), alphas=[as_t(alpha)]) if dcresnet else {}
    ts, tdm = tb.d_step_gc(ts, as_t(x), as_y(y), as_t(z), noise=[noise[k] for k in tb.d_leaves],
                           **tpen)
    assert_d_step(st_d, jdm, ts, tdm, dcresnet)
    assert float(np.mean(np.asarray(jdm["frac_clipped"]))) > 0.5
    for k in ("norm_mean", "norm_std", "norm_max"):
        assert l2rel(np.asarray(jdm[k]), tdm[k].numpy()) < 2e-3, k
    np.testing.assert_allclose(tdm["frac_clipped"].numpy(), np.asarray(jdm["frac_clipped"]),
                               atol=1e-6)
