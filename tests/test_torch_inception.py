"""The port's InceptionV3 for FID (csl_gan_tpu_torch/tools/inception.py) and
its weight converter against the JAX package's, on the CPU (the Inception
path of tools/fid.py: tests/test_torch_inception_fid.py).

The canonical pt_inception weights are not in the repository, so the
network is held on seeded random weights, as tests/test_inception_parity.py
holds the JAX network: its fan-in-scaled weights keep the activations O(1) through the 94
convolutions. Tolerance: rtol = atol = 2e-4 on the [N, 2048] features, that
file's; both run fp32 convolutions in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inception_parity import scaled_random_params

import convert_inception_weights as jconv_w
from csl_gan_tpu.tools import fid as jfid
from csl_gan_tpu.tools import inception as jinc
from csl_gan_tpu_torch import convert_inception_weights as tconv_w
from csl_gan_tpu_torch.tools import fid
from csl_gan_tpu_torch.tools import inception as tinc

torch.set_num_threads(2)
TOL = 2e-4


@pytest.fixture(scope="module")
def params():
    return scaled_random_params()


@pytest.fixture(scope="module")
def net(params):
    return tinc.build(params)


def _jax_features(params, imgs):
    return np.asarray(jax.jit(lambda x: jinc.inception_features(jinc._Params(params), x))(imgs))


def test_param_shapes_are_the_jax_packages():
    """Names, HWIO shapes and forward order of every weight."""
    got, want = tinc.param_shapes(), jinc.param_shapes()
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("seed", [0, 3])
def test_random_params_equal_jax_bitwise(seed):
    got, want = tinc.random_params(seed), jinc.random_params(seed)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(v)), k


@pytest.mark.parametrize("seed", [7, 13])
def test_scaled_random_params_equal_the_parity_tests_bitwise(seed):
    """The port's fan-in-scaled weights (the card-vs-CPU check's) are the
    weights this file and tests/test_inception_parity.py hold the networks on."""
    got, want = tinc.scaled_random_params(seed), scaled_random_params(seed)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k


@pytest.mark.parametrize("res,ch", [(32, 3), (64, 3), (28, 1)])
def test_features_match_jax(params, net, res, ch):
    imgs = np.random.default_rng(11).random((2, res, res, ch)).astype(np.float32)
    got, want = tinc.features(net, imgs), _jax_features(params, imgs)
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_downsampling_input_matches_jax(params, net):
    """Above 299 px ``jax.image.resize`` antialiases; the port's resize does
    too, so the images and features agree. Without the antialiasing the
    resized images would differ by far more than the features' tolerance."""
    imgs = np.random.default_rng(12).random((2, 320, 320, 3)).astype(np.float32)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    want_img = np.asarray(jax.image.resize(jnp.asarray(imgs), (2, 299, 299, 3), "bilinear"))
    got_img = tinc.resize_299(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_img, want_img, rtol=1e-5, atol=1e-5)
    plain = torch.nn.functional.interpolate(x, size=(299, 299), mode="bilinear",
                                            align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want_img).max() > 100 * TOL
    got, want = tinc.features(net, imgs), _jax_features(params, imgs)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_one_npz_gives_the_same_features_in_both_packages(params, tmp_path, monkeypatch):
    """An npz read through ``load_params`` / ``make_inception_features`` of
    each package; with ``$FID_INCEPTION_WEIGHTS`` set, "auto" takes it and
    labels the result "fid"."""
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    loaded = tinc.load_params(path)
    assert set(loaded) == set(params)
    imgs = np.random.default_rng(13).random((3, 28, 28, 1)).astype(np.float32)
    got = tinc.make_inception_features(path, "cpu")(imgs)
    np.testing.assert_allclose(got, np.asarray(jinc.make_inception_features(path)(imgs)),
                               rtol=TOL, atol=TOL)
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", path)
    fn, label = fid.make_feature_fn("auto", "cpu")
    assert label == "fid" and jfid.make_feature_fn("auto")[1] == "fid"
    np.testing.assert_array_equal(fn(imgs), got)


def test_weight_converter_writes_the_root_tools_npz(params, tmp_path):
    """A pytorch_fid state dict (OIHW convs, ``fc`` and ``num_batches_tracked``
    beside) gives the same arrays through both converters, and loads into
    the port's network by name."""
    state = {}
    for name, arr in params.items():
        t = torch.from_numpy(arr)
        state[name] = t.permute(3, 2, 0, 1).contiguous() if arr.ndim == 4 else t
        if name.endswith(".bn.running_var"):
            state[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    state["fc.weight"] = torch.zeros(1008, 2048)
    state["fc.bias"] = torch.zeros(1008)
    src = tmp_path / "ckpt.pth"
    torch.save(state, src)
    jconv_w.main(str(src), str(tmp_path / "jax.npz"))
    tconv_w.main([str(src), str(tmp_path / "port.npz")])
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(params)
    for name in params:
        np.testing.assert_array_equal(b[name], a[name])
        np.testing.assert_array_equal(b[name], params[name])
    net = tinc.FIDInceptionV3()
    net.load_state_dict({k: v for k, v in state.items() if not k.startswith("fc.")})
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
