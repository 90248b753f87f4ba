"""One immediate-sensitivity D step of the port (training/steps.py
``d_step_is``) against the JAX package's ``_d_step_is``, on the CPU, for the
MNIST vanilla model and a small DCResNet (the recipe of
tests/test_torch_celeba_step.py: WGAN-GP on mean samples, ACGAN wasserstein),
each in the four variants: flat, ``-ispp true`` (per parameter),
``-issm constant-pl`` with a torch-order ``-issv`` vector, and
``-issm moving-avg-pl`` with ``--moving_avg_beta``; all fp32.

Every JAX draw is recomputed from the step's keys and handed to the port: z
(key row 0), the unit normals of the noise (row 1: JAX's
``add_gaussian_noise`` with sigma 1 and unit stds), the penalty's
interpolation weights (row 2). The port adds the penalty's gradient to g as
a constant taken without a graph (its inputs do not depend on x); the JAX
package differentiates one loss that holds it. The values are the same
function, so the tolerances below are those of reduction order.

Tolerances. The sensitivity is a second-order gradient: the packages differ
in reduction order only, and is_sens (scalar or per leaf) and the scaling
vector are held to 1e-4 relative (normalized l2 for vectors). Params and
Adam moments after the step are held to < 2e-3 in normalized l2, the bound
of tests/test_torch_gc_step.py; the loss metrics to 1e-4 relative.

Beside the parity, the port's sensitivity is checked against central finite
differences of ||g(x)|| and of each ||g_l(x)|| along random directions of
x (float64), after the JAX package's tests/test_steps.py:128.
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
MNIST = ["MNIST", "--conditional", "-dpm", "is", "--sigma", "0.7", "-bs", str(BS),
         "-tss", "80", "--manual_seed", "5"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "is",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-bs", str(BS), "-tss", "64",
        "--train_d_until_threshold", "1e18", "--manual_seed", "5"]
# Torch-order -issv vectors (weight before bias), one entry per D parameter.
ISSV = {"mnist": ["3", "0.5", "2", "0.25", "4", "0.75"],
        "dcresnet": ["20", "2", "15", "1", "30", "25", "1.5"]}
VARIANTS = {"flat": [], "per-param": ["-ispp", "true"],
            "constant-pl": ["-issm", "constant-pl", "-issv"],
            "moving-avg-pl": ["-issm", "moving-avg-pl", "--moving_avg_beta", "0.8", "-issv"]}



@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


def _args(model, variant):
    args = (MNIST if model == "mnist" else DCRN) + VARIANTS[variant]
    return args + ISSV[model] if args[-1] == "-issv" else args


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("model", ["mnist", "dcresnet"])
def test_d_step_is_matches_jax(tmp_path, model, variant):
    args = _args(model, variant)
    dcresnet = model == "dcresnet"
    jopt = options.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)

    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if dcresnet else x

    d_key = jax.random.PRNGKey(41)
    st_d, jdm = jax.jit(jb._d_step_is)(st, jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(pen_x), jnp.asarray(y), d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    n_leaves = len(jax.tree_util.tree_leaves(zeros_d))
    eps_tree = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, 1.0, jnp.ones(n_leaves), per_layer=True)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))

    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping, scaling_vec=host.scaling_vec, g_batch_stats=host.g_batch_stats)
    # -dpm is: the DCResNet G is the BatchNorm one (bn = not per_sample_grad).
    assert tb.g_has_bn == jb.g_has_bn == dcresnet
    # The port resolves -issv (torch order) into the JAX package's leaf-order vector.
    np.testing.assert_array_equal(convert.scaling_vec_to_jax(tb.init_state().scaling_vec),
                                  np.asarray(host.scaling_vec))
    yt = torch.tensor(y, dtype=torch.int64)
    eps = [eps_tree[k] for k in tb.d_leaves]
    pen = dict(pen_x=_t(pen_x), pen_y=yt, alphas=[_t(alpha)]) if dcresnet else {}
    ts, tdm = tb.d_step_is(ts, _t(x), yt, _t(z), eps, **pen)
    out = convert.train_state_to_jax(ts)

    host_d = jax.device_get(st_d)
    sens_j, sens_t = np.asarray(jdm["is_sens"]), tdm["is_sens"].numpy()
    assert sens_t.shape == sens_j.shape == ((n_leaves,) if variant == "per-param" else ())
    assert np.all(sens_j > 0) if variant != "per-param" else sens_j.max() > 0
    assert _l2rel(sens_j, sens_t) < 1e-4
    assert _l2rel(np.asarray(host_d.scaling_vec), out["scaling_vec"]) < 1e-4
    if variant == "moving-avg-pl":
        assert not np.allclose(out["scaling_vec"], np.asarray(host.scaling_vec))
    if dcresnet:      # the fakes' G forward moved the running averages
        assert _l2rel(host_d.g_batch_stats, out["g_batch_stats"]) < 1e-4
    assert _l2rel(host_d.d_params, out["d_params"]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert int(host_d.d_opt_state[0].count) == out["d_adam"][2] == 1
    keys = ["d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss"]
    for k in keys + (["penalty"] if dcresnet else []):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("d_real_acc", "d_fake_acc", "d_real_aux_acc"):
        assert abs(float(tdm[k]) - float(jdm[k])) < 1e-3, k


def test_sensitivity_matches_finite_differences(tmp_path):
    """is_sens of the flat and per-parameter steps is the norm of the input
    gradient of ||g|| and of each ||g_l||. That gradient (autograd, float64)
    is held against central finite differences along random directions of
    x, and the steps' is_sens to its norms."""
    b = 2
    args = ["MNIST", "--conditional", "-dpm", "is", "-bs", "8", "-tss", "80"]
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.uniform(0, 1, (b, 28, 28, 1)), dtype=torch.float64)
    y = torch.tensor(rng.integers(0, 10, b), dtype=torch.int64)
    z = torch.tensor(rng.standard_normal((b, 100)), dtype=torch.float64)
    sens = {}
    for variant in ("flat", "per-param"):
        opt = toptions.parse(args + VARIANTS[variant] + ["--platform", "cpu",
                                                         "-o", str(tmp_path / variant)])
        G, D = init_models(opt, torch.device("cpu"))
        tb = StepBuilder(opt, G, D)
        st = tb.init_state()
        st.d_params = {k: v.double() for k, v in st.d_params.items()}
        st.g_params = {k: v.double() for k, v in st.g_params.items()}
        st.d_mu = {k: v.double() for k, v in st.d_mu.items()}
        st.d_nu = {k: v.double() for k, v in st.d_nu.items()}
        eps = [torch.zeros_like(st.d_params[k]) for k in tb.d_leaves]
        _, m = tb.d_step_is(st, x, y, z, eps)
        sens[variant] = m["is_sens"].double().numpy()
    fake = tb.fakes(st.g_params, z, y)
    p = {k: v.detach().requires_grad_(True) for k, v in st.d_params.items()}

    def leaf_norms(xx, graph=False):
        with torch.enable_grad():
            total = tb._full_batch_loss(p, xx, y, fake)[0]
            g = torch.autograd.grad(total, [p[k] for k in tb.d_leaves], create_graph=graph)
            return torch.stack([torch.sqrt(torch.sum(gi ** 2)) for gi in g])

    x_in = x.clone().requires_grad_(True)
    with torch.enable_grad():
        n = leaf_norms(x_in, graph=True)
        jac = torch.stack([torch.autograd.grad(n[i], x_in, retain_graph=True)[0].reshape(-1)
                           for i in range(len(n))])
    n0 = n.detach()
    h = 1e-5
    for seed in range(3):
        v = torch.tensor(np.random.default_rng(seed).standard_normal(x.shape))
        fd = (leaf_norms(x + h * v) - leaf_norms(x - h * v)) / (2 * h)
        np.testing.assert_allclose((jac @ v.reshape(-1)).numpy(), fd.numpy(), rtol=1e-5,
                                   atol=1e-10)
    # d||g|| / dx = sum_l (||g_l|| / ||g||) d||g_l|| / dx
    np.testing.assert_allclose(sens["flat"], float(torch.norm((n0 / torch.norm(n0)) @ jac)),
                               rtol=1e-4)
    np.testing.assert_allclose(sens["per-param"], torch.norm(jac, dim=1).numpy(), rtol=1e-4,
                               atol=1e-9)


def test_unit_normals_and_scaled_noise():
    """One flat draw sliced per leaf; the stds stay a device tensor."""
    leaves = [torch.zeros(3, 4), torch.zeros(5), torch.zeros(2, 2, 2)]
    gen = torch.Generator().manual_seed(3)
    eps = gops.unit_normals(gen, leaves)
    flat = torch.randn(12 + 5 + 8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.cat([e.reshape(-1) for e in eps]), flat)
    assert [e.shape for e in eps] == [l.shape for l in leaves]
    stds = torch.tensor([0.5, 2.0, 0.0])
    out = gops.add_scaled_noise(leaves, eps, stds)
    for o, e, s in zip(out, eps, stds):
        assert torch.equal(o, s * e)
    g = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    np.testing.assert_allclose(gops.per_leaf_norms(g).numpy(), [5.0, 12.0])
    assert float(gops.global_norm(g)) == 13.0
