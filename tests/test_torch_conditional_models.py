"""The port's models for unconditional runs and the CGAN, WCGAN and embedded-G
variants (csl_gan_tpu_torch/models/{mnist,dcresnet}.py) against the JAX
package's, on the CPU: for each variant on the MNIST vanilla pair and the
MNIST DCResNet pair, the G and D forwards on the same converted params, the
JAX package's model anchors (tests/test_models.py), ``convert.py`` both ways,
and a port checkpoint byte for byte the JAX package's that loads in either
package.

Tolerance: fp32 forwards differ by reduction order only (and, in the
DCResNet G, by the JAX package's phase form of the upsample-conv): 1e-5 in
normalized l2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options as joptions
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu.training import checkpoint as jckpt
from csl_gan_tpu.training.steps import TrainStepBuilder
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models import dcresnet as tdcr
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.privacy import accountant_from_state_dict
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.steps import StepBuilder

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)

TOL = 1e-5
BS = 6
VANILLA = ["MNIST", "-dpm", "gc", "--sigma", "0.7", "-bs", "8", "-tss", "80",
           "--manual_seed", "5"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "-dpm", "gc", "--penalty", "WGAN-GP",
        "-nms", "1", "--mean_sample_size", "4", "-bs", "8", "-tss", "80",
        "--train_d_until_threshold", "1e18", "--manual_seed", "5"]
COND = ["--conditional"]
VARIANTS = {
    "uncond": [],
    "cgan": COND + ["--conditional_arch", "CGAN"],
    "wcgan": COND + ["--conditional_arch", "WCGAN"],
}
CASES = {f"vanilla-{v}": VANILLA + a for v, a in VARIANTS.items()}
CASES.update({f"dcresnet-{v}": DCRN + a for v, a in VARIANTS.items()})
CASES["dcresnet-embed"] = DCRN + COND + ["--g_label_emb_mode", "embed"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _pair(tmp_path, args):
    """(JAX opt, (G, Gv), (D, Dv), port opt, port G, port D with the JAX
    params)."""
    jopt = joptions.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tG.load_state_dict(convert.params_from_jax(jax.device_get(Gv["params"]), "G"))
    tD.load_state_dict(convert.params_from_jax(jax.device_get(Dv["params"]), "D"))
    return jopt, (G, Gv), (D, Dv), topt, tG, tD


def _inputs(opt, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((BS, opt.g_latent_dim)).astype(np.float32)
    y = rng.integers(0, opt.n_classes, BS).astype(np.int32) if opt.conditional else None
    x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    return z, y, x


@pytest.mark.parametrize("name", list(CASES))
def test_forwards_match_jax(tmp_path, name):
    jopt, (G, Gv), (D, Dv), topt, tG, tD = _pair(tmp_path, CASES[name])
    z, y, x = _inputs(jopt)
    jy = None if y is None else jnp.asarray(y)
    ty = None if y is None else torch.tensor(y, dtype=torch.int64)
    want = G.apply(Gv, jnp.asarray(z), jy, train=True)
    with torch.no_grad():
        got = tG(torch.tensor(z), ty)
    assert got.shape == want.shape and _rel(got.numpy(), want) < TOL
    for aux in (True, False):
        w_out, w_aux = D.apply(Dv, jnp.asarray(x), jy, aux=aux)
        with torch.no_grad():
            g_out, g_aux = tD(torch.tensor(x), ty, aux=aux)
        assert g_out.shape == w_out.shape and _rel(g_out.numpy(), w_out) < TOL
        # A WCGAN's head is its critic: computed whatever aux says.
        assert (g_aux is None) == (w_aux is None), aux
        if w_aux is not None:
            assert _rel(g_aux.numpy(), w_aux) < TOL
    assert (w_aux is not None) == (name.endswith("wcgan") and name.startswith("dcresnet"))


def test_cgan_celeba_d_param_count(tmp_path):
    """CGAN's D input is 3 + n_classes planes (tests/test_models.py:44-51)."""
    opt = toptions.parse(["CelebA", "--conditional", "--conditional_arch", "CGAN",
                          "-tss", "12800", "--platform", "cpu", "-o", str(tmp_path)])
    _, D = init_models(opt, torch.device("cpu"))
    assert sum(p.numel() for p in D.parameters()) == 4317952
    assert D.TorchConv_0.weight.shape == (64, 5, 5, 5) and not hasattr(D, "linOutAux")


def test_acgan_d_ignores_input_labels():
    D = tdcr.celeba_d48(n_classes=2, conditional_arch="ACGAN")
    x = torch.ones(2, 48, 48, 3)
    with torch.no_grad():
        o1, a1 = D(x, torch.zeros(2, dtype=torch.int64))
        o2, a2 = D(x, torch.ones(2, dtype=torch.int64))
    assert torch.equal(o1, o2) and torch.equal(a1, a2) and a1.shape == (2, 2)


def test_wcgan_out_is_the_label_selected_head_column():
    D = tdcr.celeba_d48(n_classes=2, conditional_arch="WCGAN")
    assert not hasattr(D, "linOut") and D.TorchConv_0.weight.shape[1] == 5
    x = torch.randn(3, 48, 48, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1, 0])
    with torch.no_grad():
        out, aux = D(x, y, aux=False)
    assert torch.equal(out, torch.take_along_dim(aux, y[:, None], dim=1))


@pytest.mark.parametrize("name", list(CASES))
def test_convert_round_trips(tmp_path, name):
    """The flax trees -> state dicts of the port's models (names and shapes:
    Embed_0, a WCGAN D without linOut, a CGAN conv1 of 1 + n_classes input
    channels) -> the same flax trees; D's leaf order is the JAX tree's."""
    jopt, (G, Gv), (D, Dv), topt, tG, tD = _pair(tmp_path, CASES[name])
    for tree, model, kind in ((Gv["params"], tG, "G"), (Dv["params"], tD, "D")):
        tree = jax.device_get(tree)
        sd = convert.params_from_jax(tree, kind)
        ref = model.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in ref.items() if k in sd}
        assert set(ref) - set(sd) <= {k for k in ref if k.endswith((".mean", ".var"))}
        back = convert.params_to_jax(sd, kind)
        la, ta = jax.tree_util.tree_flatten(back)
        lb, tb = jax.tree_util.tree_flatten(tree)
        assert ta == tb
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, np.asarray(b))
    b = StepBuilder(topt, tG, tD)
    want = [".".join(str(p.key) for p in path if p.key != "Conv_0")
            .replace("kernel", "weight") for path, _ in
            jax.tree_util.tree_flatten_with_path(jax.device_get(Dv["params"]))[0]]
    assert list(b.d_leaves) == want
    if name == "dcresnet-embed":
        assert "Embed_0.weight" in tG.state_dict()
        assert tG.TorchDense_0.weight.shape[1] == topt.g_latent_dim
    if name == "dcresnet-cgan":
        assert tD.TorchConv_0.weight.shape[1] == 11


@pytest.fixture(scope="module", params=list(CASES))
def saved(request, tmp_path_factory):
    """(name, JAX builder, a JAX state with random Adam moments, port
    template state, accountant, dir)."""
    args = CASES[request.param]
    out = tmp_path_factory.mktemp(request.param)
    opt = joptions.parse(args + ["-o", str(out / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(opt)
    b = TrainStepBuilder(opt, G, D)
    st = jax.device_get(b.init_state(Gv, Dv))
    rng = np.random.default_rng(9)
    rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), t)
    adam = lambda s: (s[0]._replace(mu=rand(s[0].mu), nu=rand(s[0].nu), count=np.int32(3)),) \
        + tuple(s[1:])  # noqa: E731
    st = st.replace(d_params=rand(st.d_params), g_params=rand(st.g_params),
                    d_opt_state=adam(st.d_opt_state), g_opt_state=adam(st.g_opt_state))
    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(out / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    template = StepBuilder(topt, tG, tD).init_state()
    acc = JaxRdpAccountant(8, 80, 0.7)
    acc.step(20)
    return request.param, b, st, template, acc, out


def _port_state(st):
    a = lambda s: (s[0].mu, s[0].nu, int(s[0].count))  # noqa: E731
    return convert.train_state_from_jax(st.d_params, st.g_params, a(st.d_opt_state),
                                        a(st.g_opt_state), np.asarray(st.clipping))


def test_port_save_is_the_jax_bytes_and_loads_both_ways(saved):
    name, b, st, template, acc, out = saved
    jckpt.save_pair(str(out / "j"), 2, 1, st, acc.state_dict())
    port = _port_state(st)
    checkpoint.save_pair(str(out / "p"), 2, 1, port,
                         accountant_from_state_dict(acc.state_dict()).state_dict())
    for f in ("G-2", "D-2"):
        assert (out / "p" / "saves" / f).read_bytes() == \
            (out / "j" / "saves" / f).read_bytes(), f
    # The JAX save resumes in the port, the port's in the JAX package.
    got, _ = checkpoint.load_g(str(out / "j" / "saves" / "G-2"), template)
    got, _, _, _ = checkpoint.load_d(str(out / "j" / "saves" / "D-2"), got)
    for field in ("d_params", "g_params", "d_mu", "g_nu"):
        x, y = getattr(got, field), getattr(port, field)
        assert sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x), field
    (_, Gv), (_, Dv) = jax_init_models(b.opt)
    js, _ = jckpt.load_g(str(out / "p" / "saves" / "G-2"), b.init_state(Gv, Dv))
    js, _, _ = jckpt.load_d(str(out / "p" / "saves" / "D-2"), js)
    la, ta = jax.tree_util.tree_flatten(jax.device_get(js))
    lb, tb = jax.tree_util.tree_flatten(st)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("extra,message", [
    (["--conditional", "--d_label_emb_mode", "embed"], "Embed for D not implemented"),
    (["--conditional", "--g_label_emb_mode", "embed"],
     "Vanilla model with embedded labels not implemented"),
])
def test_label_refusals_are_the_jax_packages(tmp_path, extra, message):
    """The JAX package's own refusals, with its messages: the D's embed mode
    (csl_gan_tpu/options.py:568-575), embedded labels on the vanilla model,
    and a non-cross-entropy aux loss on the conditional vanilla D
    (csl_gan_tpu/models/mnist.py:62-64)."""
    base = DCRN if "--d_label_emb_mode" in extra else VANILLA
    for parse in (joptions.parse, toptions.parse):
        with pytest.raises(Exception, match=message):
            parse(base + extra + ["-o", str(tmp_path)])
    opt = toptions.parse(VANILLA + ["--conditional", "--aux_loss_type", "cross_entropy",
                                    "--platform", "cpu", "-o", str(tmp_path)])
    opt.aux_loss_type = "wasserstein"
    with pytest.raises(Exception, match="Cross entropy loss is the only aux loss"):
        init_models(opt, torch.device("cpu"))
