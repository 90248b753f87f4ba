"""The port's ghost-clipped real pass and DP noise (csl_gan_tpu_torch/ops)
against the JAX package's ops/ghost.py on the CPU, bs 32, noise off.

Both sides compute the same fp32 arithmetic in other reduction orders:
summed grads agree to rtol 1e-5 / atol 1e-6, ClipStats to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import ghost as jghost
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import ghost, grads


@pytest.fixture(scope="module")
def d_params(tmp_path_factory):
    d = tmp_path_factory.mktemp("ghost")
    _, (_, D_vars) = jax_init_models(options.parse(
        ["MNIST", "--conditional", "-dpm", "gc", "-o", str(d)]))
    return jax.tree_util.tree_map(np.asarray, D_vars["params"])


# C = 4.0 (the MNIST default) clips some rows; C = 0.05 clips nearly all.
@pytest.mark.parametrize("clip", [4.0, 0.05])
def test_vanilla_real_ghost_matches(d_params, clip):
    rng = np.random.default_rng(3)
    b = 32
    x = rng.random((b, 28, 28, 1), np.float32)
    y = rng.integers(0, 10, b)
    oh = np.eye(10, dtype=np.float32)[y]
    s_j, st_j, (out_j, aux_j) = jghost.vanilla_real_ghost(
        d_params, jnp.asarray(x), jnp.asarray(oh), jnp.asarray(y), 1.0,
        jnp.float32(clip), False)
    tp = convert.params_from_jax(d_params, "D")
    s_t, st_t, (out_t, aux_t) = ghost.vanilla_real_ghost(
        tp, torch.tensor(x), torch.tensor(oh), torch.tensor(y), 1.0, clip)

    back = convert.params_to_jax(s_t, "D")
    for (pa, a), (pb, bb) in zip(jax.tree_util.tree_leaves_with_path(s_j),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_allclose(bb, np.asarray(a), rtol=1e-5, atol=1e-6,
                                   err_msg=str(pa))
    for name in ("norm_mean", "norm_std", "norm_max", "frac_clipped"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), rtol=1e-5, atol=1e-6)
    if clip < 1.0:
        assert float(st_t.frac_clipped.min()) > 0.9


def test_clip_factors_flat():
    norms = torch.tensor([[3.0, 0.0], [4.0, 0.0]])
    f = grads.clip_factors(norms, 1.0, per_layer=False)
    np.testing.assert_allclose(f.numpy(), [[0.2, 1.0], [0.2, 1.0]], rtol=1e-6)


def test_gaussian_noise_std():
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.zeros(200, 300), torch.zeros(5000)]
    noised = grads.add_gaussian_noise(gen, leaves, sigma=10.0, max_norm=4.0)
    for n in noised:
        assert abs(float(n.std()) - 40.0) < 1.5
        assert abs(float(n.mean())) < 1.5
