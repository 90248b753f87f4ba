"""The port's checkpoints (csl_gan_tpu_torch/training/checkpoint.py) against
the JAX package's (csl_gan_tpu/training/checkpoint.py), both ways, for the
MNIST vanilla conditional pair and a small DeepConvResNet pair with
per-layer clipping, each after one DP D step and one G step in the JAX
package:

- a JAX ``save_pair`` loaded by the port is exactly
  ``convert.train_state_from_jax`` of the same state;
- a port save loaded by JAX ``load_g`` / ``load_d`` is exactly
  ``convert.train_state_to_jax``, its extra run-state key notwithstanding,
  and the accountant's dict round-trips;
- the port writes the same bytes as the JAX package for the same state;
- a save that does not fit the model raises.

A third case is the DeepConvResNet pair under ``-dpm is -issm
moving-avg-pl``: its D save carries the moving scaling vector and its G, the
BatchNorm generator of the non-per-sample-grad modes, its running averages
(``batch_stats``).
"""

import dataclasses

import jax
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
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.privacy import accountant_from_state_dict
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8
MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", str(BS),
         "-tss", "80", "--manual_seed", "5"]
# The small DeepConvResNet config of the verify notes, with per-layer clipping.
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "-bs", str(BS), "-tss", "80",
        "--train_d_until_threshold", "1e18", "--manual_seed", "5",
        "-gcm", "constant-pl"]
# -dpm is with the moving-average per-layer scaling, on the small DeepConvResNet.
DCRN_IS = [a for a in DCRN if a not in ("-gcm", "constant-pl")]
DCRN_IS[DCRN_IS.index("gc")] = "is"
DCRN_IS += ["-issm", "moving-avg-pl", "--moving_avg_beta", "0.6"]
CASES = {"mnist": MNIST, "dcresnet-per-layer": DCRN, "dcresnet-is-moving-avg": DCRN_IS}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(opt_state):
    s = opt_state[0]
    return _np(s.mu), _np(s.nu), int(s.count)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    """(name, JAX builder, JAX state after one D and one G step, port
    template state, accountant)."""
    args = CASES[request.param]
    out = tmp_path_factory.mktemp(request.param)
    opt = joptions.parse(args + ["-o", str(out / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(opt)
    b = TrainStepBuilder(opt, G, D)
    state = b.init_state(Gv, Dv)
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    x = jax.random.uniform(k[0], (BS, 28, 28, 1))
    y = jax.random.randint(k[1], (BS,), 0, opt.n_classes)
    if opt.dp_mode == "is":
        state, _ = b.d_step_dp(state, x, y, x, y, k[2])
    else:
        state, _ = b.d_step_dp(state, x, y, x, y, x, y, k[2])
    state, _ = b.g_step(state, k[3])
    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(out / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    template = StepBuilder(topt, tG, tD).init_state()
    acc = JaxRdpAccountant(BS, 80, 0.7)
    acc.step(30)
    return request.param, b, state, template, acc, out


def _port_state(jax_state):
    return convert.train_state_from_jax(
        _np(jax_state.d_params), _np(jax_state.g_params), _adam(jax_state.d_opt_state),
        _adam(jax_state.g_opt_state), np.asarray(jax_state.clipping),
        scaling_vec=np.asarray(jax_state.scaling_vec), g_batch_stats=_np(jax_state.g_batch_stats))


def _assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), f.name
            for k in x:
                assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), (f.name, k)
        elif isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y), \
                (f.name, x, y)
        else:
            assert x == y and type(x) is type(y), (f.name, x, y)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_jax_save_loads_in_the_port_exactly(case):
    name, b, jstate, template, acc, out = case
    jckpt.save_pair(str(out / "j2p"), 4, 3, jstate, acc.state_dict())
    st, g_epoch = checkpoint.load_g(str(out / "j2p" / "saves" / "G-4"), template)
    st, d_epoch, acc_state, run_state = checkpoint.load_d(
        str(out / "j2p" / "saves" / "D-4"), st)
    assert (g_epoch, d_epoch, run_state) == (3, 3, None)
    _assert_states_equal(st, _port_state(jstate))
    assert isinstance(st.clipping, tuple) == (name == "dcresnet-per-layer")
    # The moving scaling vector and the BatchNorm G's running averages came
    # over, moved by the JAX step from their initial ones and 0.
    assert isinstance(st.scaling_vec, torch.Tensor) == (name == "dcresnet-is-moving-avg")
    assert bool(st.g_batch_stats) == (name == "dcresnet-is-moving-avg")
    if st.g_batch_stats:
        assert not torch.equal(st.scaling_vec, template.scaling_vec)
        assert all(v.abs().max() > 0 for k, v in st.g_batch_stats.items() if k.endswith("mean"))
    assert acc_state == acc.state_dict()
    port_acc = accountant_from_state_dict(acc_state)
    assert port_acc.get_privacy_spent(1e-5) == acc.get_privacy_spent(1e-5)


def test_port_save_loads_in_jax_exactly(case):
    name, b, jstate, template, acc, out = case
    port_state = _port_state(jstate)
    port_acc = accountant_from_state_dict(acc.state_dict())
    run_state = {"device": "cpu", "gen": b"\x01\x02", "gen_perm": b"\x03"}
    checkpoint.save_pair(str(out / "p2j"), 5, 4, port_state, port_acc.state_dict(), run_state)
    (_, Gv), (_, Dv) = jax_init_models(b.opt)
    st, g_epoch = jckpt.load_g(str(out / "p2j" / "saves" / "G-5"), b.init_state(Gv, Dv))
    st, d_epoch, acc_state = jckpt.load_d(str(out / "p2j" / "saves" / "D-5"), st)
    assert (g_epoch, d_epoch) == (4, 4)
    want = convert.train_state_to_jax(port_state)
    _assert_trees_equal(st.d_params, want["d_params"])
    _assert_trees_equal(st.g_params, want["g_params"])
    for got, (mu, nu, count) in ((st.d_opt_state, want["d_adam"]),
                                 (st.g_opt_state, want["g_adam"])):
        _assert_trees_equal(got[0].mu, mu)
        _assert_trees_equal(got[0].nu, nu)
        assert np.asarray(got[0].count).dtype == np.int32 and int(got[0].count) == count
    _assert_trees_equal(st.clipping, want["clipping"])
    _assert_trees_equal(st.scaling_vec, want["scaling_vec"])
    _assert_trees_equal(st.g_batch_stats, want["g_batch_stats"])
    _assert_trees_equal(st, jstate)         # the JAX state came back whole
    assert acc_state == port_acc.state_dict() == acc.state_dict()
    _, _, _, rs = checkpoint.load_d(str(out / "p2j" / "saves" / "D-5"), template)
    assert rs == run_state


def test_port_writes_the_jax_packages_bytes(case):
    name, b, jstate, template, acc, out = case
    jckpt.save_pair(str(out / "jb"), 2, 1, jstate, acc.state_dict())
    checkpoint.save_pair(str(out / "pb"), 2, 1, _port_state(jstate),
                         accountant_from_state_dict(acc.state_dict()).state_dict())
    for f in ("G-2", "D-2"):
        assert (out / "pb" / "saves" / f).read_bytes() == \
            (out / "jb" / "saves" / f).read_bytes(), f


def test_a_save_that_does_not_fit_raises(case, tmp_path):
    name, b, jstate, template, acc, out = case
    jckpt.save_pair(str(tmp_path), 1, 0, jstate, acc.state_dict())
    with pytest.raises(ValueError, match="model_state_dict"):
        checkpoint.load_d(str(tmp_path / "saves" / "G-1"), template)
    with pytest.raises(ValueError, match="model_state_dict"):
        checkpoint.load_g(str(tmp_path / "saves" / "D-1"), template)
    (tmp_path / "bad").write_bytes(b"\x82\xa1a\x01")
    with pytest.raises(ValueError):
        checkpoint.load_g(str(tmp_path / "bad"), template)
