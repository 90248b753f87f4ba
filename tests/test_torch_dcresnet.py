"""The port's DCResNet pair (csl_gan_tpu_torch/models/dcresnet.py) against
the JAX package's, on the CPU: convert.py carries both param trees across
exactly, with the same weights the MNIST pair's forwards agree, and the
full-width CelebA pair has the JAX package's param tree.

Tolerances: fp32 forwards differ only by reduction order and, in G, by the
JAX package's phase form of the upsample-conv (taps pre-summed) against the
port's plain upsample + conv: 1e-4 relative. bf16 compute rounds the conv
outputs at other places in the two packages (and the JAX phase form rounds
the pre-summed taps to bf16), which compounds over the layers: normalised l2
below 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu.models import dcresnet as jdcr
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.models import dcresnet as tdcr


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _jax_pair(g_ctor, d_ctor, img, n_classes=10, dtype=None, **gkw):
    G = g_ctor(n_classes=n_classes, bn=False, dtype=dtype, **gkw)
    D = d_ctor(n_classes=n_classes, dtype=dtype)
    z = jnp.zeros((1, G.z_dim))
    y = jnp.zeros((1,), jnp.int32)
    gv = G.init(jax.random.PRNGKey(0), z, y, train=True)
    dv = D.init(jax.random.PRNGKey(1), jnp.zeros((1,) + img), y)
    return G, gv["params"], D, dv["params"]


def _port_pair(g_ctor, d_ctor, gp, dp, n_classes=10, dtype=None):
    G = g_ctor(n_classes=n_classes, dtype=dtype)
    D = d_ctor(n_classes=n_classes, dtype=dtype)
    G.load_state_dict(convert.params_from_jax(gp, "G"))
    D.load_state_dict(convert.params_from_jax(dp, "D"))
    return G, D


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_convert_round_trips_the_dcresnet_trees():
    _, gp, _, dp = _jax_pair(jdcr.mnist_dcrn_g, jdcr.mnist_dcrn_d, (28, 28, 1))
    gsd, dsd = convert.params_from_jax(gp, "G"), convert.params_from_jax(dp, "D")
    G, D = tdcr.mnist_dcrn_g(n_classes=10), tdcr.mnist_dcrn_d(n_classes=10)
    for sd, model in ((gsd, G), (dsd, D)):
        ref = model.state_dict()
        assert set(sd) == set(ref)
        for k, v in sd.items():
            assert v.shape == ref[k].shape, k
    _same_tree(convert.params_to_jax(gsd, "G"), jax.device_get(gp))
    _same_tree(convert.params_to_jax(dsd, "D"), jax.device_get(dp))
    # D's leaf order (norms, clip stats, noise) is the JAX tree's.
    want = [".".join(str(p.key) for p in path if p.key != "Conv_0").replace("kernel", "weight")
            for path, _ in jax.tree_util.tree_flatten_with_path(dp)[0]]
    assert tdcr.d_leaves(D) == want


def test_train_state_round_trip_carries_adam():
    _, gp, _, dp = _jax_pair(jdcr.mnist_dcrn_g, jdcr.mnist_dcrn_d, (28, 28, 1))
    rng = np.random.default_rng(0)
    noisy = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), t)
    st = convert.train_state_from_jax(dp, gp, (noisy(dp), noisy(dp), 7),
                                      (noisy(gp), noisy(gp), 3), 0.5)
    back = convert.train_state_to_jax(st)
    assert back["d_adam"][2] == 7 and back["g_adam"][2] == 3
    _same_tree(back["d_params"], jax.device_get(dp))
    _same_tree(back["g_adam"][1], convert.params_to_jax(st.g_nu, "G"))


@pytest.mark.parametrize("phase_gn4", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_mnist_dcresnet_forwards_match_jax(phase_gn4, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    G, gp, D, dp = _jax_pair(jdcr.mnist_dcrn_g, jdcr.mnist_dcrn_d, (28, 28, 1),
                             dtype=jdt, phase_gn4=phase_gn4)
    tG, tD = _port_pair(tdcr.mnist_dcrn_g, tdcr.mnist_dcrn_d, gp, dp, dtype=tdt)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((4, 128)).astype(np.float32)
    y = np.array([0, 3, 7, 9], np.int32)
    want = np.asarray(G.apply({"params": gp}, jnp.asarray(z), jnp.asarray(y), train=True))
    with torch.no_grad():
        got = tG(torch.tensor(z), torch.tensor(y, dtype=torch.int64))
    assert got.shape == (4, 28, 28, 1) and got.dtype == torch.float32
    tol = 3e-2 if bf16 else 1e-4
    assert _rel(got.numpy(), want) < tol
    x = want
    w_out, w_aux = D.apply({"params": dp}, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        g_out, g_aux = tD(torch.tensor(x), torch.tensor(y, dtype=torch.int64))
    assert g_out.dtype == g_aux.dtype == torch.float32
    assert _rel(g_out.numpy(), np.asarray(w_out)) < tol
    assert _rel(g_aux.numpy(), np.asarray(w_aux)) < tol


def test_celeba_pair_trees_match_jax():
    """The full-width celeba_g64 / celeba_d64 pair has the JAX package's
    param tree, name for name and shape for shape (traced with
    jax.eval_shape: a CPU compile of the CelebA convs takes minutes, and the
    forward math is the MNIST pair's, compared above)."""
    z, y = jnp.zeros((1, 128)), jnp.zeros((1,), jnp.int32)
    gp = jax.eval_shape(lambda: jdcr.celeba_g64(n_classes=2, bn=False).init(
        jax.random.PRNGKey(0), z, y, train=True))["params"]
    dp = jax.eval_shape(lambda: jdcr.celeba_d64(n_classes=2).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), y))["params"]
    for tree, model, kind in ((gp, tdcr.celeba_g64(n_classes=2), "G"),
                              (dp, tdcr.celeba_d64(n_classes=2), "D")):
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), tree)
        sd = convert.params_from_jax(zeros, kind)
        ref = model.state_dict()
        assert set(sd) == set(ref)
        for k, v in sd.items():
            assert v.shape == ref[k].shape, k
