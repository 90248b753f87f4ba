"""The port's MNIST vanilla models, losses and weight converter against the
JAX package's, on the CPU, at full width (the models are small).

Forwards and losses are fp32 on both sides (JAX's DEFAULT-precision dots
are fp32 on the CPU), so they agree to rtol 1e-5 / atol 1e-6; the converter
is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models import losses as jlosses
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models import losses as tlosses
from csl_gan_tpu_torch.models.mnist import D_LEAVES, G_LEAVES
from csl_gan_tpu_torch.models.registry import init_models

TOL = dict(rtol=1e-5, atol=1e-6)
ARGS = ["MNIST", "--conditional", "-dpm", "gc", "--manual_seed", "5"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (G, G_vars), (D, D_vars) = jax_init_models(options.parse(ARGS + ["-o", str(d / "j")]))
    topt = toptions.parse(ARGS + ["--platform", "cpu", "-o", str(d / "t")])
    tG, tD = init_models(topt, torch.device("cpu"))
    return G, G_vars, D, D_vars, tG, tD


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["G", "D"])
def test_converter_round_trip_is_exact(models, kind):
    G, G_vars, D, D_vars, tG, tD = models
    tree = _np((G_vars if kind == "G" else D_vars)["params"])
    sd = convert.params_from_jax(tree, kind)
    assert set(sd) == set(G_LEAVES if kind == "G" else D_LEAVES)
    module = tG if kind == "G" else tD
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in module.state_dict().items()}
    back = convert.params_to_jax(sd, kind)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_is_torch_default_uniform(models):
    *_, tG, tD = models
    for m in (tG, tD):
        for layer in m.children():
            bound = 1.0 / layer.in_features ** 0.5
            for p in (layer.weight.detach(), layer.bias.detach()):
                assert float(p.abs().max()) <= bound
                assert float(p.abs().max()) > 0.5 * bound


def test_d_forward_matches(models):
    G, G_vars, D, D_vars, tG, tD = models
    rng = np.random.default_rng(0)
    x = rng.random((16, 28, 28, 1), np.float32)
    y = rng.integers(0, 10, 16)
    out, aux = D.apply(D_vars, jnp.asarray(x), jnp.asarray(y))
    tD.load_state_dict(convert.params_from_jax(_np(D_vars["params"]), "D"))
    tout, taux = tD(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(taux.detach().numpy(), np.asarray(aux), **TOL)


def test_g_forward_matches(models):
    G, G_vars, D, D_vars, tG, tD = models
    rng = np.random.default_rng(1)
    z = rng.standard_normal((16, 100)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    img = G.apply(G_vars, jnp.asarray(z), jnp.asarray(y))
    tG.load_state_dict(convert.params_from_jax(_np(G_vars["params"]), "G"))
    timg = tG(torch.tensor(z), torch.tensor(y))
    assert tuple(timg.shape) == (16, 28, 28, 1)
    np.testing.assert_allclose(timg.detach().numpy(), np.asarray(img), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match(reduction):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((32, 1)) * 4).astype(np.float32)
    aux = (rng.standard_normal((32, 10)) * 3).astype(np.float32)
    y = rng.integers(0, 10, 32)
    tl, ta, ty = torch.tensor(logits), torch.tensor(aux), torch.tensor(y)
    jl, ja, jy = jnp.asarray(logits), jnp.asarray(aux), jnp.asarray(y)
    pairs = [
        (tlosses.d_real_loss("vanilla", tl, reduction),
         jlosses.d_real_loss("vanilla", jl, reduction)),
        (tlosses.d_fake_loss("vanilla", tl, reduction),
         jlosses.d_fake_loss("vanilla", jl, reduction)),
        (tlosses.g_adv_loss("vanilla", tl, reduction),
         jlosses.g_adv_loss("vanilla", jl, reduction)),
        (tlosses.softmax_cross_entropy(ta, ty, reduction),
         jlosses.softmax_cross_entropy(ja, jy, reduction)),
        (tlosses.aux_loss("ACGAN", "cross_entropy", 1.5, ta, ty, 10, reduction=reduction),
         jlosses.aux_loss("ACGAN", "cross_entropy", 1.5, ja, jy, 10, reduction=reduction)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_train_state_round_trip(models):
    G, G_vars, D, D_vars, tG, tD = models
    d, g = _np(D_vars["params"]), _np(G_vars["params"])
    twice = jax.tree_util.tree_map(lambda a: a * 2, d)
    st = convert.train_state_from_jax(d, g, (twice, d, 7), (g, g, 9), np.float32(4.0))
    assert st.d_count == 7 and st.g_count == 9 and st.clipping == 4.0
    back = convert.train_state_to_jax(st)
    for a, b in zip(jax.tree_util.tree_leaves(twice),
                    jax.tree_util.tree_leaves(back["d_adam"][0])):
        np.testing.assert_array_equal(a, b)
    assert back["d_adam"][2] == 7 and back["g_adam"][2] == 9
