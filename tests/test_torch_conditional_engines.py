"""The port's other D steps and its G steps for unconditional runs and the
CGAN and WCGAN variants (and the DCResNet G's embedded label) against the
JAX package's, on the CPU:

  - one ``d_step_is`` (flat), ``d_step_tmsv`` (tm) and the non-private D
    step (the vanilla model's ``d_step``; the DCResNet's ``d_step_plain``),
    against JAX ``_d_step_is`` / ``_d_step_tmsv`` / ``_d_step_plain``;
  - one G step of each variant (``g_step``, ``g_step_dcresnet``) against JAX
    ``_g_step``.

Every JAX draw is recomputed from the step's keys and handed to the port:
z (key row 0), the noise (row 1: unit normals for is, Student-t(3) for tm),
the penalty's interpolation weights (the last row); the G step's z and
labels (rows 0 and 1).

Tolerances, those of tests/test_torch_dp_modes.py and
tests/test_torch_is_step.py (all fp32; the packages differ by reduction
order only): params and Adam moments after a step within 2e-3 in normalized
l2 (nu 4e-3), loss metrics, the penalty and is_sens within 1e-4 relative,
accuracies within 1e-3 (percent).
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


# ---------------- is, tm and the non-private D steps ----------------

ENGINES = {"is": (STEP_VANILLA, ["-dpm", "is"]),
           "tm": (STEP_VANILLA, ["-dpm", "tm", "--tm_m", "2"]),
           "plain-vanilla": (STEP_VANILLA, []), "plain-dcresnet": (STEP_DCRN, [])}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_other_d_steps_match_jax(tmp_path, engine, variant):
    base, extra = ENGINES[engine]
    dcresnet = base is STEP_DCRN
    jb, st, tb, ts = builders(tmp_path, base + extra + VARIANTS[variant])
    x, y, pen_x = batch(jb.opt, dcresnet, 3)
    d_key = jax.random.PRNGKey(41)
    step = {"is": jb._d_step_is, "tm": jb._d_step_tmsv}.get(engine, jb._d_step_plain)
    st_d, jdm = jax.jit(step)(st, jnp.asarray(x), as_j(y), jnp.asarray(pen_x), as_j(y), d_key)
    kd = key_rows(d_key, 2 if step == jb._d_step_plain else 3)
    z = as_t(jb.gen_z(kd[0], BS))
    leaves, treedef = jax.tree_util.tree_flatten(st.d_params)
    noise = None
    if engine == "is":
        zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
        tree = jgops.add_gaussian_noise(kd[1], zeros_d, 1.0, jnp.ones(len(leaves)),
                                        per_layer=True)
    elif engine == "tm":
        keys = jax.random.split(kd[1], len(leaves))
        tree = jax.tree_util.tree_unflatten(
            treedef, [jax.random.t(k, 3.0, l.shape) for k, l in zip(keys, leaves)])
    if engine in ("is", "tm"):
        tree = convert.params_from_jax(jax.device_get(tree), "D")
        noise = [tree[k] for k in tb.d_leaves]
    alpha = jax.random.uniform(jax.random.split(kd[-1], 1)[0], (BS, 1, 1, 1))
    pen = dict(pen_x=as_t(pen_x), pen_y=as_y(y), alphas=[as_t(alpha)]) if dcresnet else {}
    if dcresnet:
        # The non-private DCResNet G is the BatchNorm one, whose batch
        # statistics each package sums in its own order: the fakes differ at
        # rounding level, and through D's leaky-ReLU masks and the penalty
        # that moved one D moment just past 2e-3 (the unconditional case).
        # So the D step is compared on the JAX package's fakes, and the
        # fakes on their own.
        j_fake, _ = jb._fake_images(st, jb.gen_z(kd[0], BS), as_j(y))
        own = tb._step_fakes
        assert rel(own(ts, z, as_y(y))[0].numpy(), j_fake) < 1e-5
        tb._step_fakes = lambda state, zz, yy: (as_t(j_fake), own(state, zz, yy)[1])
    ts, tdm = tb.d_core(ts, as_t(x), as_y(y), z, engine in ("is", "tm"), noise=noise, **pen)
    out = assert_d_step(st_d, jdm, ts, tdm, dcresnet)
    if engine == "is":
        np.testing.assert_allclose(float(tdm["is_sens"]), float(jdm["is_sens"]), rtol=1e-4)
    if dcresnet:     # the non-private DCResNet G is BatchNorm: its averages moved
        assert l2rel(jax.device_get(st_d).g_batch_stats, out["g_batch_stats"]) < 1e-4


# ---------------- the G step ----------------

G_CASES = {f"vanilla-{v}": STEP_VANILLA + ["-dpm", "gc"] + a for v, a in VARIANTS.items()}
G_CASES.update({f"dcresnet-{v}": STEP_DCRN + ["-dpm", "gc"] + a for v, a in VARIANTS.items()})
G_CASES["dcresnet-embed"] = STEP_DCRN + ["-dpm", "gc", "--conditional", "--g_label_emb_mode",
                                    "embed"]


@pytest.mark.parametrize("name", list(G_CASES))
def test_g_step_matches_jax(tmp_path, name):
    jb, st, tb, ts = builders(tmp_path, G_CASES[name])
    g_key = jax.random.PRNGKey(17)
    st_g, jgm = jax.jit(jb._g_step)(st, g_key)
    kg = key_rows(g_key, 2)
    z, y = jb.gen_z(kg[0], BS), jb.gen_y(kg[1], BS)
    assert (y is None) == (not jb.opt.conditional)
    if tb.family == "vanilla":
        oh = None if y is None else torch.nn.functional.one_hot(as_y(y), 10).float()
        ts, tgm = tb.g_step(ts, as_t(z), oh)
    else:
        ts, tgm = tb.g_step_dcresnet(ts, as_t(z), as_y(y))
    out = convert.train_state_to_jax(ts)
    h = jax.device_get(st_g)
    assert l2rel(h.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    assert l2rel(h.g_opt_state[0].nu, out["g_adam"][1]) < 4e-3
    assert l2rel(h.g_params, out["g_params"]) < 2e-3
    # The aux metrics are ACGAN's alone (the embedded-G case).
    assert sorted(tgm) == sorted(jgm) == \
        (["g_adv_loss"] if name != "dcresnet-embed" else ["g_adv_loss", "g_aux_acc", "g_aux_loss"])
    for k in tgm:
        np.testing.assert_allclose(float(tgm[k]), float(jgm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if name == "dcresnet-embed":     # the embedding learned
        assert l2rel(h.g_params["Embed_0"], out["g_params"]["Embed_0"]) < 2e-3
        assert not np.array_equal(out["g_params"]["Embed_0"]["embedding"],
                                  np.asarray(jax.device_get(st).g_params["Embed_0"]["embedding"]))
