"""The port's ops/grads.py against the JAX package's, function by function,
on the CPU: the vanilla MNIST D and a narrow two-conv DCResNet D
(1 -> 8 -> 16 channels on 28x28), batch 8, fp32.

Both packages get the same numpy-seeded weights (through convert.py) and
inputs and compute the same fp32 arithmetic in other reduction orders: sums
and norms are held to 1e-5 in relative l2, clip statistics to 1e-5. Inside
the port, the materialized clipped sum over ``real_ps_args`` is held against
the ghost routes (``vanilla_real_ghost``, ``dcresnet_real_ghost``), the same
sum from analytic norms, also to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from csl_gan_tpu.models import dcresnet as jdcr
from csl_gan_tpu.models import mnist as jmnist
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models import dcresnet as tdcr
from csl_gan_tpu_torch.models import mnist as tmnist
from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import conv_ghost, ghost
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_clip
from csl_gan_tpu_torch.training.steps import StepBuilder

B, NC = 8, 10


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _tree_rel(port_sd, jax_tree):
    """Worst relative l2 over the leaves of a port dict against a JAX tree."""
    back = convert.params_to_jax(port_sd, "D")
    la, ta = jax.tree_util.tree_flatten(back)
    lb, tb = jax.tree_util.tree_flatten(jax.device_get(jax_tree))
    assert ta == tb
    return max(_rel(x, y) for x, y in zip(la, lb))


def _stats_close(st_t, st_j):
    for name in ("norm_mean", "norm_std", "norm_max", "frac_clipped"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module", params=["vanilla", "dcresnet"])
def case(request):
    """(JAX loss_fn, JAX params, port loss_fn, port params in leaf order,
    x, y): per-sample loss -out + CE(aux, y) on both sides."""
    if request.param == "vanilla":
        jD, tD = jmnist.MNISTVanillaD(n_classes=NC), tmnist.MNISTVanillaD(n_classes=NC)
        leaves = tmnist.D_LEAVES
    else:
        jD = jdcr.DCResNetDiscriminator(channels=[1, 8, 16], last_filter_size=7, n_classes=NC)
        tD = tdcr.DCResNetDiscriminator(channels=[1, 8, 16], last_filter_size=7, n_classes=NC)
        leaves = tdcr.d_leaves(tD)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, NC, B).astype(np.int32)
    jp = jD.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.asarray(y[:1]))["params"]
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)), jp)
    sd = convert.params_from_jax(jax.device_get(jp), "D")
    tp = {k: sd[k] for k in leaves}

    def jloss(p, xi, yi):
        out, aux = jD.apply({"params": p}, xi[None], yi[None])
        return -out[0, 0] - jnp.sum(jax.nn.one_hot(yi, NC) * jax.nn.log_softmax(aux[0]))

    def tloss(p, xi, yi):
        out, aux = functional_call(tD, p, (xi[None], yi[None]))
        return -out[0, 0] - torch.sum(one_hot(yi, NC) * torch.log_softmax(aux[0], dim=-1))

    return jloss, jp, tloss, tp, x, y


def _args(case):
    jloss, jp, tloss, tp, x, y = case
    return ((jloss, jp, jnp.asarray(x), jnp.asarray(y)),
            (tloss, tp, torch.tensor(x), torch.tensor(y, dtype=torch.int64)))


@pytest.mark.parametrize("chunk", [None, 3])
def test_per_sample_grads_and_leaf_norms_match_jax(case, chunk):
    ja, ta = _args(case)
    g_j = jgops.per_sample_grads(*ja, chunk=chunk)
    g_t = gops.per_sample_grads(*ta, chunk=chunk)
    assert all(v.shape[0] == B for v in g_t.values())
    for i in (0, B - 1):
        assert _tree_rel({k: v[i] for k, v in g_t.items()},
                         jax.tree_util.tree_map(lambda a: a[i], g_j)) < 1e-5
    n_j, n_t = jgops._leaf_norms(g_j), gops.leaf_norms(g_t)
    assert n_t.shape == (len(ta[1]), B)
    assert _rel(n_t.numpy(), n_j) < 1e-5
    rng = np.random.default_rng(5)
    f = rng.uniform(0.1, 1.0, n_t.shape).astype(np.float32)
    assert _tree_rel(gops.weighted_sum(g_t, torch.tensor(f)),
                     jgops._weighted_sum(g_j, jnp.asarray(f))) < 1e-5


@pytest.mark.parametrize("per_layer", [False, True])
def test_clip_factors_match_jax(per_layer):
    rng = np.random.default_rng(6)
    norms = rng.uniform(0.0, 3.0, (5, 16)).astype(np.float32)
    norms[2, 3] = 0.0
    c = [0.5, 1.0, 2.0, 0.1, 4.0] if per_layer else 1.5
    want = jgops.clip_factors(jnp.asarray(norms), c, per_layer)
    got = gops.clip_factors(torch.tensor(norms), c, per_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    _stats_close(gops.stats_from_norms(torch.tensor(norms), got),
                 jgops._stats_from_norms(jnp.asarray(norms), want))


def _thresholds(n_leaves, per_layer):
    # Low enough that most rows are clipped on every leaf.
    return [0.05 * (i + 1) for i in range(n_leaves)] if per_layer else 0.3


@pytest.mark.parametrize("chunk,per_layer", [(None, False), (3, False), (None, True), (3, True)])
def test_clipped_grad_sum_matches_jax(case, chunk, per_layer):
    ja, ta = _args(case)
    c = _thresholds(len(ta[1]), per_layer)
    s_j, st_j = jgops.clipped_grad_sum(*ja, max_norm=c, per_layer=per_layer, chunk=chunk)
    s_t, st_t = gops.clipped_grad_sum(*ta, max_norm=c, per_layer=per_layer, chunk=chunk)
    assert float(np.mean(np.asarray(st_j.frac_clipped))) > 0.5
    assert _tree_rel(s_t, s_j) < 1e-5
    _stats_close(st_t, st_j)


@pytest.mark.parametrize("per_layer", [False, True])
def test_two_pass_clipped_grad_sum_matches_jax(case, per_layer):
    ja, ta = _args(case)
    c = _thresholds(len(ta[1]), per_layer)
    s_j, st_j = jgops.two_pass_clipped_grad_sum(*ja, max_norm=c, per_layer=per_layer)
    s_t, st_t = gops.two_pass_clipped_grad_sum(*ta, max_norm=c, per_layer=per_layer)
    assert _tree_rel(s_t, s_j) < 1e-5
    _stats_close(st_t, st_j)
    one, _ = gops.clipped_grad_sum(*ta, max_norm=c, per_layer=per_layer)
    assert max(_rel(s_t[k], one[k]) for k in one) < 1e-5


def test_fused_sum_is_the_unfused_sum_plus_the_drawn_noise(case, monkeypatch):
    """At std = 0 the fused sum equals the unfused one (the generator still
    runs); with noise it adds std * the pre-drawn normals to a small leaf and
    std * the seed's Philox stream to a large one; a chunk refuses it. The
    leaf gate is lowered so that the narrow conv D has large leaves too."""
    monkeypatch.setattr(pallas_clip, "MIN_PALLAS_ELEMS", 3000)
    _, ta = _args(case)
    leaves = list(ta[1].values())
    n = len(leaves)
    plain, st_p = gops.clipped_grad_sum(*ta, max_norm=0.3)
    gen = torch.Generator().manual_seed(3)
    large = [l.numel() >= pallas_clip.MIN_PALLAS_ELEMS for l in leaves]
    assert any(large) and not all(large)
    for std in (0.0, 0.7):
        fused = gops.draw_fused_noise(gen, leaves, torch.full((n,), std))
        assert [e is None for e in fused.eps] == large and fused.seeds.dtype == torch.int64
        got, st_f = gops.clipped_grad_sum(*ta, max_norm=0.3, fused_noise=fused)
        _stats_close(st_f, st_p)
        for i, k in enumerate(ta[1]):
            eps = fused.eps[i] if not large[i] else pallas_clip.philox_normal(
                fused.seeds[i], leaves[i].numel()).reshape(leaves[i].shape)
            np.testing.assert_allclose(got[k].numpy(), (plain[k] + std * eps).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="chunked"):
        gops.clipped_grad_sum(*ta, max_norm=0.3, chunk=4, fused_noise=fused)


def test_noise_stds_and_add_gaussian_noise():
    leaves = [torch.zeros(3, 5), torch.zeros(7), torch.zeros(2, 2, 2)]
    assert gops.noise_stds(3, 0.5, 200.0, False) == [100.0] * 3
    c = [1000.0, 5.0, 2500.0]
    want = np.asarray(jgops._noise_stds(leaves, 0.7, c, True))
    stds = gops.noise_stds(3, 0.7, c, True)
    np.testing.assert_array_equal(np.asarray(stds, np.float32), want)
    unit = gops.noise_like(torch.Generator().manual_seed(9), leaves, 1.0)
    got = gops.add_gaussian_noise(torch.Generator().manual_seed(9), leaves, 0.7, c, True)
    for g, u, s in zip(got, unit, stds):
        assert g.shape == u.shape
        np.testing.assert_allclose(g.numpy(), (u * s).numpy(), rtol=1e-6)
    lead = gops.noise_like(torch.Generator().manual_seed(9), leaves, stds, lead=(4,))
    assert [tuple(t.shape) for t in lead] == [(4, 3, 5), (4, 7), (4, 2, 2, 2)]


GC = ["--conditional", "-dpm", "gc", "-bs", str(B), "-tss", "64", "--platform", "cpu"]


@pytest.mark.parametrize("model,per_layer", [("vanilla", False), ("vanilla", True),
                                             ("dcresnet", False), ("dcresnet", True)])
def test_materialized_sum_equals_the_ghost_sum(tmp_path, model, per_layer):
    """The port's own oracle for its ghost clipping: the clipped real sum
    from vmap(grad) against the sum from analytic norms, <= 1e-5 (fp32)."""
    extra = ["--model", "DeepConvResNet", "--aux_loss_type", "wasserstein",
             "--train_d_until_threshold", "1e18"] if model == "dcresnet" else []
    extra += ["-gcm", "constant-pl"] if per_layer else []
    opt = toptions.parse(["MNIST"] + GC + extra + ["-o", str(tmp_path)])
    G, D = init_models(opt, torch.device("cpu"))
    b = StepBuilder(opt, G, D)
    params = b.init_state().d_params
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32))
    y = torch.tensor(rng.integers(0, NC, B))
    c = _thresholds(len(b.d_leaves), per_layer)
    row_w = b.row_weights(y)
    f, args = b.real_ps_args(x, y, row_w)
    want, st_w = gops.clipped_grad_sum(f, params, *args, max_norm=c, per_layer=per_layer)
    if model == "vanilla":
        got, st_g, _ = ghost.vanilla_real_ghost(params, x, one_hot(y, NC), y, b.aux_scalar,
                                                c, per_layer)
    else:
        got, st_g, _ = conv_ghost.dcresnet_real_ghost(
            params, x, y, n_classes=NC, arch=b.arch, aux_type=b.aux_type,
            aux_scalar=b.aux_scalar, row_w=row_w, max_norm=c, per_layer=per_layer)
    assert float(st_w.frac_clipped.mean()) > 0.5
    assert max(_rel(got[k], want[k]) for k in b.d_leaves) < 1e-5
    _stats_close(st_g, st_w)
