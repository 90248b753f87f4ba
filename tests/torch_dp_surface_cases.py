"""Draws and step runners shared by the tests of the port's Poisson
subsampling, per-sample and DRAGAN penalties and backprop clipping
(tests/test_torch_{poisson,penalty_surface,backprop_clip}.py).

Every JAX draw of a D step is recomputed from the step's keys (JAX
``key_rows``: z row 0, the DP noise row 1, the penalty row 2) and handed to
the port: the batch penalty's draws (one key per penalty, JAX
``calc_penalty``), the per-sample penalty's (one key per sample, split per
penalty, JAX ``_d_step_gc``'s ``pen_keys``), the gc noise
(``add_gaussian_noise`` at sigma * C), is's unit normals, tm's Student-t(3)
and sv's normals per leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training.penalty import draw_shape
from torch_conditional_cases import as_j, as_t, as_y


def penalty_draws(key, types, shape):
    """JAX calc_penalty's draws from ``key`` for a batch of ``shape``."""
    keys = jax.random.split(key, len(types))
    return [as_t(jax.random.uniform(k, draw_shape(t, shape))) for t, k in zip(types, keys)]


def ps_penalty_draws(key, types, shape):
    """The per-sample penalty's draws: sample j's row of penalty i comes from
    split(split(key, B)[j], n_types)[i]."""
    rows = [penalty_draws(k, types, (1,) + tuple(shape[1:]))
            for k in jax.random.split(key, shape[0])]
    return [torch.cat([r[i] for r in rows]) for i in range(len(types))]


def gc_pair(jb, st, tb, ts, x, y, pen_x=None, pen_y=None, valid=None, seed=31):
    """One JAX ``_d_step_gc`` and the port's ``d_step_gc`` on the same state,
    batch and draws. On the port's fused route (K6's plain version) the
    noise is zero, so the case runs at sigma 0. Returns (JAX state, JAX
    metrics, port state, port metrics)."""
    d_key = jax.random.PRNGKey(seed)
    jv = None if valid is None else jnp.asarray(valid)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), as_j(y), as_j(pen_x), as_j(pen_y),
                                       jnp.asarray(x), as_j(y), d_key, jv)
    kd = key_rows(d_key, 3)
    b = x.shape[0]
    z = as_t(jb.gen_z(kd[0], b))
    types = jb.penalty_types
    pen = {}
    if types:
        pen = dict(pen_x=as_t(pen_x), pen_y=as_y(pen_y),
                   alphas=penalty_draws(kd[2], types, pen_x.shape))
    if tb.ps_pen:
        pen["ps_draws"] = ps_penalty_draws(kd[2], types, x.shape)
    leaves = [ts.d_params[k] for k in tb.d_leaves]
    if tb.fused_route:
        assert tb.sigma == 0
        noise = dict(fused=gops.draw_fused_noise(torch.Generator().manual_seed(1), leaves,
                                                 torch.zeros(len(leaves))))
    else:
        zeros = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
        tree = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
            kd[1], zeros, jb.sigma, st.clipping, per_layer=jb.per_layer)), "D")
        noise = dict(noise=[tree[k] for k in tb.d_leaves])
    new, tdm = tb.d_step_gc(ts, as_t(x), as_y(y), z, valid=as_t(valid), **noise, **pen)
    return st_d, jdm, new, tdm


def engine_pair(jb, st, tb, ts, engine, x, y, pen_x, pen_y, seed=41):
    """One JAX ``_d_step_is`` / ``_d_step_tmsv`` (tm, sv) and the port's
    counterpart on the same state, batch, penalty batch and draws."""
    d_key = jax.random.PRNGKey(seed)
    step = jb._d_step_is if engine == "is" else jb._d_step_tmsv
    st_d, jdm = jax.jit(step)(st, jnp.asarray(x), as_j(y), as_j(pen_x), as_j(pen_y), d_key)
    kd = key_rows(d_key, 3)
    z = as_t(jb.gen_z(kd[0], x.shape[0]))
    leaves, treedef = jax.tree_util.tree_flatten(st.d_params)
    if engine == "is":
        zeros = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
        tree = jgops.add_gaussian_noise(kd[1], zeros, 1.0, jnp.ones(len(leaves)),
                                        per_layer=True)
    else:
        keys = jax.random.split(kd[1], len(leaves))
        draw = (lambda k, s: jax.random.t(k, 3.0, s)) if engine == "tm" else jax.random.normal
        tree = jax.tree_util.tree_unflatten(
            treedef, [draw(k, l.shape) for k, l in zip(keys, leaves)])
    tree = convert.params_from_jax(jax.device_get(tree), "D")
    noise = [tree[k] for k in tb.d_leaves]
    pen = {}
    if jb.penalty_types:
        pen = dict(pen_x=as_t(pen_x), pen_y=as_y(pen_y),
                   alphas=penalty_draws(kd[2], jb.penalty_types, pen_x.shape))
    new, tdm = tb.d_core(ts, as_t(x), as_y(y), z, True, noise=noise, **pen)
    return st_d, jdm, new, tdm


def assert_stats(jdm, tdm, tol=2e-3):
    """The clip statistics of a gc step against the JAX step's."""
    for k in ("norm_mean", "norm_std", "norm_max"):
        a, b = np.asarray(jdm[k], np.float64), tdm[k].numpy().astype(np.float64)
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(a) + 1e-12, k
    np.testing.assert_allclose(tdm["frac_clipped"].numpy(), np.asarray(jdm["frac_clipped"]),
                               atol=1e-6)
