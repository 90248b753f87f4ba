"""The port's whole-epoch function (csl_gan_tpu_torch/ops/pallas_epoch.py)
against the JAX package's Pallas megakernel K1 in interpret mode, on the CPU.

Both sides consume the same pre-drawn inputs: the rows, z, labels and DP
noise are drawn on the JAX side with K1's own schedule
(csl_gan_tpu/ops/pallas_epoch.py:492-514) and handed to the port as numpy
arrays, with the JAX state converted to the port's layouts. Tolerances are
those of tests/test_pallas_epoch.py: single-step agreement is ~1e-7, and over
two epochs reduce-order drift compounds through Adam, so params and moments
are held to a normalized l2 gap < 2e-3 and metric sums to rtol 2e-4 /
atol 1e-4.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.ops import grads as gops
from csl_gan_tpu.ops import pallas_epoch
from csl_gan_tpu.training.loop import Trainer
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch as tpe
from csl_gan_tpu_torch.training.steps import StepBuilder

ARGS = ["MNIST", "--conditional", "--sigma", "0.7", "-bs", "32", "-tss", "160",
        "--manual_seed", "3", "-ne", "4", "--log_every", "100000000",
        "--sample_every", "100000000", "--save_every", "100000"]


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


def _draw(b, state, rng, perm_key, images, n, e, use_dp):
    """K1's per-epoch inputs, with its key schedule (pallas_epoch.py:492-514)."""
    bs, nc = b.opt.batch_size, b.n_classes
    perm = jax.random.permutation(jax.random.fold_in(perm_key, e), images.shape[0])
    rows = images[perm[: n * bs]]
    base = jax.random.fold_in(rng, e)
    cols = jnp.arange(n)[:, None] * 8 + jnp.arange(8)[None, :]
    keys = jax.vmap(jax.vmap(lambda t: jax.random.fold_in(base, t)))(cols)
    z_d = jax.vmap(lambda k: b.gen_z(k, bs))(keys[:, 0])
    z_g = jax.vmap(lambda k: b.gen_z(k, bs))(keys[:, 3])
    y_g = jax.vmap(lambda k: b.gen_y(k, bs))(keys[:, 4])
    ohg = jax.nn.one_hot(y_g, nc)
    noise = None
    if use_dp:
        zeros_d = jax.tree_util.tree_map(jnp.zeros_like, state.d_params)
        tree = jax.vmap(lambda k: gops.add_gaussian_noise(
            k, zeros_d, b.sigma, state.clipping, per_layer=False))(keys[:, 1])
        # JAX layout [n, in, out] -> torch layout [n, out, in]
        noise = [torch.tensor(np.ascontiguousarray(
            np.swapaxes(np.asarray(l), 1, 2) if l.ndim == 3 else np.asarray(l)))
            for l in jax.tree_util.tree_leaves(tree)]
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    rows_t = t(rows.astype(jnp.float32)).to(rows_dtype(rows))
    return rows_t, t(z_d), t(z_g), t(ohg), noise


def rows_dtype(rows):
    return torch.bfloat16 if rows.dtype == jnp.bfloat16 else torch.float32


def _port_builder(tmp_path, extra):
    opt = toptions.parse(ARGS + list(extra) + ["--platform", "cpu",
                                               "-o", str(tmp_path / "port")])
    G, D = init_models(opt, torch.device("cpu"))
    b = StepBuilder(opt, G, D)
    b.labels_in_table = b.onehot_in_table = True
    return b


@pytest.mark.parametrize("use_dp", [True, False])
def test_epoch_matches_k1_interpret(tmp_path, use_dp):
    extra = ["-dpm", "gc"] if use_dp else []
    tr = Trainer(options.parse(ARGS + extra + ["-o", str(tmp_path / "jax")]))
    b = tr.builder
    assert pallas_epoch.supports(b, use_dp, 1)
    n, k = len(tr.dataloader), 2
    st = tr.state
    host = jax.tree_util.tree_map(np.asarray, st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping)

    # JAX reference: the megakernel's epochs runner in interpret mode.
    pall = pallas_epoch.build_pallas_epochs_runner(b, k, n, use_dp=use_dp,
                                                   interpret=True)
    g_mask = jnp.ones((n,), bool)
    zero = tr._get_zero_acc(use_dp, tr._get_runner(use_dp),
                            (st, tr._seg_rng, *tr._dev_data, tr._perm_key, 0,
                             g_mask, jnp.zeros(()), jnp.zeros(()), None, 0))
    images = tr._dev_data[0]
    draws = [_draw(b, st, tr._seg_rng, tr._perm_key, images, n, e, use_dp)
             for e in range(k)]
    st_j, _, d_j, g_j, c_j, _ = pall(jax.tree_util.tree_map(jnp.array, st),
                                     tr._seg_rng, *tr._dev_data, tr._perm_key,
                                     g_mask, jnp.zeros(()), jnp.zeros(()), zero, 0)

    # Port: the same inputs through epoch_kernel on CPU tensors.
    pb = _port_builder(tmp_path, extra)
    assert tpe.supports(pb, use_dp, 1)
    params, mu, nu = tpe.leaves_of(ts)
    t = (ts.d_count, ts.g_count)
    met = torch.zeros(tpe.MET_SLOTS)
    for rows, z_d, z_g, ohg, noise in draws:
        params, mu, nu, m = tpe.epoch_kernel(pb, rows, z_d, z_g, ohg, noise,
                                             ts.clipping, t, params, mu, nu,
                                             use_dp=use_dp)
        met += m
        t = (t[0] + n, t[1] + n)
    out = convert.train_state_to_jax(tpe.state_from_leaves(params, mu, nu, ts.clipping, t))

    host_j = jax.tree_util.tree_map(np.asarray, st_j)
    assert _l2rel(host_j.d_params, out["d_params"]) < 2e-3
    assert _l2rel(host_j.g_params, out["g_params"]) < 2e-3
    assert _l2rel(host_j.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert _l2rel(host_j.d_opt_state[0].nu, out["d_adam"][1]) < 2e-3
    assert _l2rel(host_j.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    assert _l2rel(host_j.g_opt_state[0].nu, out["g_adam"][1]) < 2e-3
    assert int(host_j.d_opt_state[0].count) == out["d_adam"][2] == k * n
    assert int(host_j.g_opt_state[0].count) == out["g_adam"][2] == k * n

    met = met.numpy()
    keys = ["d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_acc",
            "d_fake_acc", "d_real_aux_loss", "d_real_aux_acc"]
    for slot, kk in enumerate(keys):
        np.testing.assert_allclose(met[slot], np.asarray(d_j[kk]),
                                   rtol=2e-4, atol=1e-4, err_msg=kk)
    for slot, kk in enumerate(["g_adv_loss", "g_aux_loss", "g_aux_acc"], start=7):
        np.testing.assert_allclose(met[slot], np.asarray(g_j[kk]),
                                   rtol=2e-4, atol=1e-4, err_msg=kk)
    if use_dp:
        for lo, kk in ((10, "norm_mean"), (16, "norm_std"), (22, "norm_max"),
                       (28, "frac_clipped")):
            np.testing.assert_allclose(met[lo:lo + 6], np.asarray(d_j[kk]),
                                       rtol=2e-4, atol=1e-4, err_msg=kk)
    assert int(c_j) == k * n


def test_epoch_kernel_takes_plain_only_for_cpu(tmp_path):
    """CPU tensors take epoch_plain; any other non-CUDA device raises (CUDA
    tensors launch the kernel, checked on the card by chip_smoke.py)."""
    pb = _port_builder(tmp_path, ["-dpm", "gc"])
    st = pb.init_state()
    params, mu, nu = tpe.leaves_of(st)
    n, bs = 1, 32
    rows = torch.zeros(n * bs, 795)
    z = torch.zeros(n, bs, 100)
    ohg = torch.zeros(n, bs, 10)
    noise = [torch.zeros((n,) + tuple(p.shape)) for p in params[:6]]
    before = tpe.epoch_kernel.launches
    out = tpe.epoch_kernel(pb, rows, z, z, ohg, noise, 4.0, (0, 0), params, mu, nu)
    assert out[3].shape == (tpe.MET_SLOTS,) and tpe.epoch_kernel.launches == before
    meta = lambda ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpe.epoch_kernel(pb, rows.to("meta"), z.to("meta"), z.to("meta"),
                         ohg.to("meta"), meta(noise), 4.0, (0, 0), meta(params),
                         meta(mu), meta(nu))


def _enum(src: str, name: str):
    """The names of `enum <name> { ... };` in a C source, in order."""
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    return [x.strip() for x in body.split(",") if x.strip()]


@pytest.mark.parametrize("enum, count", [("Ptr", "_N_PTRS"), ("Int", "_N_INTS"),
                                         ("Flt", "_N_FLOATS")])
def test_entry_point_slot_counts_match_the_kernel(enum, count):
    """The wrapper passes as many pointers, ints and floats as the C entry
    point's enums count; a mismatch would show only on the card, as
    kErrBadArgs."""
    src = (Path(tpe.__file__).parent / "csrc" / "k1_epoch.cu").read_text()
    names = _enum(src, enum)
    assert names[-1].endswith("_COUNT")
    assert len(names) - 1 == getattr(tpe, count)


def test_entry_point_ints_follow_the_int_enum(tmp_path):
    """`_ints` fills the Int slots in the enum's order."""
    src = (Path(tpe.__file__).parent / "csrc" / "k1_epoch.cu").read_text()
    names = _enum(src, "Int")[:-1]
    pb = _port_builder(tmp_path, ["-dpm", "gc"])
    rows = torch.zeros(3 * 32, 795, dtype=torch.bfloat16)
    got = dict(zip(names, tpe._ints(pb, rows, torch.zeros(3, 32, 100), (7, 9), 128, True)))
    assert got == {"I_N": 3, "I_BS": 32, "I_F": 784, "I_NC": 10, "I_LAT": 100, "I_H": 128,
                   "I_DP": 1, "I_FAUX": int(pb.d_fake_aux and pb.use_aux), "I_TD": 7,
                   "I_TG": 9, "I_RBF16": 1}


def test_build_declares_the_k1_entry_points():
    """_build binds k1_epoch_scratch and k1_epoch_plan with full-width
    argument types (an undeclared long long result would be cut to 32 bits)."""
    from csl_gan_tpu_torch.ops import _build

    class Lib:
        def __getattr__(self, name):
            fn = type(name, (), {})()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    _build._bind("k1_epoch", lib)
    IA = ctypes.POINTER(ctypes.c_int)
    assert lib.k1_epoch_scratch.argtypes == [IA, ctypes.c_int]
    assert lib.k1_epoch_scratch.restype is ctypes.c_longlong
    assert lib.k1_epoch_plan.argtypes == [IA, ctypes.c_int, IA, ctypes.c_int]
    assert lib.k1_epoch_plan.restype is ctypes.c_int
    assert len(lib.k1_epoch.argtypes) == 7
