"""The tensor axis (``--tp``) of the port, over gloo CPU ranks: the
counterparts of the JAX package's tp cases (tests/test_sharding.py:221-349)
and the port's tp steps against one device and against the JAX package's
step on ``make_mesh(n=4, tp=2)``.

Each step case starts as tests/test_torch_sharded_steps.py's do (the JAX
package's initial state with Adam moments of a run in progress, every JAX
draw handed to the port) and runs one D step and one G step on this rank's
rows and channels (tests/torch_parallel_cases.py ``steps``; one subprocess
for the 2-rank layout, tp 2, and one for the 4-rank layout, dp 2 x tp 2).
The GroupNorm DCResNet cases give the D step the one-device G's fakes, each
rank its rows, and hold each rank's own column-parallel G forward to them
at 1e-5 alone (the data axis's known sensitivity: a leaky-ReLU mask of D's
input gradient flips on the G forward's rounding).

Tolerances. Against the port's one device: every param, Adam moment and
metric within rtol 5e-4 and atol 5e-6, atol 5e-5 on the DCResNet conv-ghost
cases (test_sharding.py's tp bounds). Against the JAX mesh: those of
tests/test_torch_sharded_steps.py (params and mu 2e-3 in normalized l2, nu
4e-3, the loss metrics 1e-4 relative). The fused route's noise of every
rank's slices is the one-device draw's, bit for bit.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.parallel import make_mesh
from csl_gan_tpu.parallel.mesh import state_spec as jax_state_spec
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models import dcresnet
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_clip
from csl_gan_tpu_torch.parallel import launch
from csl_gan_tpu_torch.parallel.mesh import MeshContext, state_spec
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.steps import StepBuilder
from test_torch_sharded_steps import _noise_tree, _port_state, _warm, l2rel
from torch_conditional_cases import STEP_DCRN, STEP_VANILLA, as_j, as_t, as_y
from torch_dp_surface_cases import penalty_draws
from torch_parallel_cases import run_ranks

BS = 8
COND = ["--conditional"]
DCRN = STEP_DCRN + COND + ["--aux_loss_type", "wasserstein"]
VANILLA_GC = STEP_VANILLA + COND + ["-dpm", "gc"]
# name: (argv, engine, ranks (tp 2: 2 ranks are tp 2, 4 are dp 2 x tp 2),
# fsdp, compared with the JAX mesh, atol against one device)
CASES = {
    "vanilla-gc": (VANILLA_GC, "gc", 2, False, False, 5e-6),
    "vanilla-gc-dp2": (VANILLA_GC, "gc", 4, False, True, 5e-6),
    "conv-ghost": (DCRN + ["-dpm", "gc"], "gc", 2, False, False, 5e-5),
    "conv-ghost-fsdp-dp2": (DCRN + ["-dpm", "gc"], "gc", 4, True, True, 5e-5),
    "two-pass": (DCRN + ["-dpm", "gc", "--conv_ghost", "false"], "gc", 2, False, False, 5e-5),
    "plain-batchnorm": (DCRN, "plain", 2, False, True, 5e-5),
    "fused": (VANILLA_GC + ["--pallas", "true", "--grad_clip_split", "false"], "gc", 2, False,
              False, 5e-6),
    "fused-dcrn-dp2": (DCRN + ["-dpm", "gc", "--pallas", "true", "--grad_clip_split", "false"],
                       "gc", 4, False, False, 5e-5),
}
# Cases whose ranks also return the fused route's noise of their slices.
NOISE_ROWS = 3


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(tmp, name):
    """(the JAX state after the D and G steps on make_mesh(4, tp=2) and the
    JAX D metrics, None where the case is not compared with JAX; the port's
    payload for the ranks)."""
    argv, engine, ranks, fsdp, vs_jax, _ = CASES[name]
    jopt = options.parse(argv + ["-o", str(tmp / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = _warm(jb.init_state(Gv, Dv), 3)
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    ts = _port_state(st)

    dcr = "DeepConvResNet" in argv
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0 if dcr else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, x.shape).astype(np.float32) if tb.penalty_types else None

    ctx = make_mesh(n=4, tp=2, fsdp=fsdp)
    jb._constrain_state = ctx.constrain_state
    jst = ctx.put_state(st)
    jx, jy = ctx.put_batch(jnp.asarray(x), jnp.asarray(y))
    jpen = (as_j(pen_x), as_j(y))
    d_key = jax.random.PRNGKey(31)
    st_d = jdm = None
    if vs_jax and engine == "gc":
        st_d, jdm = jax.jit(jb._d_step_gc)(jst, jx, jy, *jpen, jnp.asarray(x), jnp.asarray(y),
                                           d_key, None)
    elif vs_jax:
        st_d, jdm = jax.jit(jb._d_step_plain)(jst, jx, jy, *jpen, d_key)
    kd = key_rows(d_key, 2 if engine == "plain" else 3)
    d = dict(x=as_t(x), y=as_y(y), z=as_t(jb.gen_z(kd[0], BS)), use_dp=engine != "plain")
    if tb.penalty_types:
        d.update(pen_x=as_t(pen_x), pen_y=as_y(y),
                 alphas=penalty_draws(kd[-1], tb.penalty_types, pen_x.shape))
    if tb.fused_route:
        leaves = [ts.d_params[k] for k in tb.d_leaves]
        stds = torch.tensor(gops.noise_stds(len(leaves), tb.sigma, ts.clipping, tb.per_layer))
        d["fused"] = gops.draw_fused_noise(torch.Generator().manual_seed(1), leaves, stds)
    elif engine != "plain":
        tree = _noise_tree(jb, st, kd[1], engine, std_one=False)
        d["noise"] = [tree[k] for k in tb.d_leaves]
    if dcr and tb.penalty_types and not tb.g_has_bn:
        d["fake"] = tb.fakes(ts.g_params, d["z"], d["y"])
    g_key = jax.random.PRNGKey(17)
    st_g = None if st_d is None else jax.device_get(jax.jit(jb._g_step)(st_d, g_key)[0])
    kg = key_rows(g_key, 2)
    g = (as_t(jb.gen_z(kg[0], BS)), as_y(jb.gen_y(kg[1], BS)))
    return st_g, jdm, dict(name=name, argv=argv, fsdp=fsdp, state=ts, d=d, g=g,
                                           noise_rows=NOISE_ROWS if tb.fused_route else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX state, JAX metrics, one-device (state, D metrics, G
    metrics, builder, the starting state), the ranks' results by rank)}."""
    tmp = tmp_path_factory.mktemp("tp")
    out, payloads = {}, {}
    for name in CASES:
        st_g, jdm, payload = _case(tmp / name, name)
        topt = toptions.parse(payload["argv"] + ["--platform", "cpu", "-o",
                                                 str(tmp / name / "one")])
        tb = StepBuilder(topt, *init_models(topt, torch.device("cpu")))
        s1, dm1 = tb.d_core(payload["state"], **payload["d"])
        s1, gm1 = tb.g_core(s1, *payload["g"])
        out[name] = [st_g, jdm, (s1, dm1, gm1, tb, payload["state"])]
        payloads.setdefault(CASES[name][2], []).append(payload)
    for ranks, cases in payloads.items():
        path = tmp / f"payload{ranks}.pt"
        torch.save(cases, path)
        res_dir = tmp / f"ranks{ranks}"
        res_dir.mkdir()
        run_ranks("steps", ranks, path, res_dir, timeout=240, tp=2)
        per_rank = [torch.load(res_dir / f"rank{r}.pt", weights_only=False)
                    for r in range(ranks)]
        for case in cases:
            out[case["name"]].append([p[case["name"]] for p in per_rank])
    return out


# ---------------- the layout (test_sharding.py's tp cases) ----------------

def _flax_axes(shape, name):
    """For each flax dim of a torch leaf, its torch dim (convert.py's
    mapping, written out here)."""
    if len(shape) == 4:
        return (2, 3, 1, 0)
    if len(shape) == 2 and "Embed" not in name:
        return (1, 0)
    return tuple(range(len(shape)))


def _expected_local(name, shape, dp, tp, fsdp):
    """The shape of the block that a rank holds of the torch leaf ``name``:
    JAX's state_spec on the flax shape."""
    axes = _flax_axes(shape, name)
    spec = tuple(jax_state_spec(tuple(shape[a] for a in axes), dp, tp, fsdp))
    out = list(shape)
    for flax_dim, ax in enumerate(spec):
        if ax is not None:
            out[axes[flax_dim]] //= dp if ax == "data" else tp
    return tuple(out)


def test_state_spec_tp_and_fsdp_compose():
    """The port's rule is JAX's (on the flax shape), and the torch dims it
    lands on: ``model`` on a weight's dim 0, ``--fsdp`` on another."""
    for shape, dp, tp, fsdp in (((5, 5, 64, 128), 4, 2, False), ((5, 5, 64, 128), 4, 2, True),
                                ((794, 129), 4, 2, True), ((792, 129), 4, 2, True),
                                ((128,), 4, 2, True), ((8192, 2), 1, 2, False),
                                ((8192, 1), 1, 2, False)):
        assert state_spec(shape, dp, tp, fsdp) == tuple(jax_state_spec(shape, dp, tp, fsdp))
    m = MeshContext(world=8, rank=5, tp=2, fsdp=True)
    assert (m.dp, m.data_index, m.model_index) == (4, 2, 1)
    assert m.leaf_layout("c.weight", (128, 64, 5, 5)) == (0, 1)
    assert m.leaf_layout("lin.weight", (128, 794)) == (0, None)
    assert m.leaf_layout("c.bias", (128,)) == (None, None)
    w = torch.arange(128 * 64 * 25, dtype=torch.float32).reshape(128, 64, 5, 5)
    assert torch.equal(m.shard_leaf(w, "c.weight"), w[64:, 32:48])


@pytest.mark.parametrize("model,want", [
    ("celeba_d64", ["TorchConv_0.weight", "TorchConv_1.weight", "TorchConv_2.weight",
                    "TorchConv_3.weight", "linOutAux.weight"]),
    ("celeba_g64", ["TorchDense_0.weight", "TorchDense_0.bias"]
     + [f"ResBlockUp_{i}.{c}.weight" for i in range(4)
        for c in ("UpsampleConv_0.TorchConv_0", "UpsampleConv_1.TorchConv_0", "TorchConv_0")])])
def test_the_flagship_leaves_that_tp_2_shards(model, want):
    """At the CelebA flagship's widths under tp 2: the D's four conv weights
    and linOutAux (2 classes), the G's dense stem (weight and bias) and
    every ResBlockUp conv weight; conv biases, linOut, the 3-channel output
    conv and the norm scales stay replicated. Each sharded leaf's model dim
    is its torch dim 0."""
    net = getattr(dcresnet, model)(n_classes=2, **({"conditional_arch": "ACGAN"}
                                                   if model.endswith("d64") else {}))
    m = MeshContext(world=2, rank=0, tp=2)
    got = [k for k, v in net.state_dict().items() if m.model_dim(k, v.shape) is not None]
    assert sorted(got) == sorted(want)
    assert all(m.model_dim(k, net.state_dict()[k].shape) == 0 for k in got)


def test_tp_must_divide_mesh():
    with pytest.raises(ValueError, match="--tp 3 must divide the mesh size 8"):
        launch.tensor_axis(Namespace(tp=3), 8)
    assert launch.tensor_axis(Namespace(tp=8), 4) == 4        # clamped to the world
    assert launch.tensor_axis(Namespace(tp=1), 4) == 1


def test_tp_flag_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 8)
    opt = toptions.parse(["MNIST", "--tp", "2", "--mesh_shape", "8", "--platform", "cpu",
                          "-o", str(tmp_path / "o")])
    world = launch.world_size(opt)
    assert (world, launch.tensor_axis(opt, world)) == (8, 2)
    assert not toptions._k1_path(opt)
    opt2 = toptions.parse(["MNIST", "--platform", "cpu", "-o", str(tmp_path / "p")])
    assert launch.tensor_axis(opt2, 8) == 1


def test_tp_state_actually_sharded(runs):
    """Each rank holds its block of every leaf (params and Adam moments,
    before and after the steps): the shape JAX's state_spec gives its flax
    shape, cut on the torch dims; some of D's params and moments are cut."""
    for name, (argv, _, ranks, fsdp, _, _) in CASES.items():
        s1 = runs[name][2][0]
        per_rank = runs[name][3]
        n_cut = 0
        for r in per_rank:
            for f in ("d_params", "d_mu", "g_params", "g_mu"):
                for k, shape in r["held"][f].items():
                    full = tuple(getattr(s1, f)[k].shape)
                    assert shape == _expected_local(k, full, ranks // 2, 2, fsdp), \
                        (name, f, k, shape)
                    n_cut += shape != full
            assert r["held_after"] == r["held"]["d_mu"]
        assert n_cut >= 4 * len(per_rank), name


def test_tp_fsdp_composed_leaves_cut_on_both_axes(runs):
    """dp 2 x tp 2 with --fsdp: some leaves are cut on both axes (a quarter
    a rank), e.g. the conv2 kernel of the MNIST DCResNet D."""
    held = runs["conv-ghost-fsdp-dp2"][3][0]["held"]
    s1 = runs["conv-ghost-fsdp-dp2"][2][0]
    quarter = [k for f in ("d_params", "g_params") for k, shape in held[f].items()
               if np.prod(getattr(s1, f)[k].shape) == 4 * np.prod(shape)]
    assert "TorchConv_1.weight" in quarter and len(quarter) >= 4


# ---------------- the steps ----------------

@pytest.mark.parametrize("name", list(CASES))
def test_tp_steps_match_one_device(runs, name):
    _, _, (s1, dm1, gm1, _, _), per_rank = runs[name]
    atol = CASES[name][5]
    got = per_rank[0]["state"]
    for f in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu", "g_batch_stats"):
        for k in getattr(s1, f):
            np.testing.assert_allclose(getattr(got, f)[k].numpy(), getattr(s1, f)[k].numpy(),
                                       rtol=5e-4, atol=atol, err_msg=f"{name} {f}[{k}]")
    assert (got.d_count, got.g_count) == (s1.d_count, s1.g_count) == (11, 11)
    for dm, m1 in ((per_rank[0]["d"], dm1), (per_rank[0]["g"], gm1)):
        assert sorted(dm) == sorted(m1)
        for k in m1:
            np.testing.assert_allclose(np.asarray(dm[k]), np.asarray(m1[k]), rtol=5e-4,
                                       atol=atol, err_msg=k)
    if per_rank[0]["fake_gap"] is not None:
        for r in per_rank:
            assert r["fake_gap"] < 1e-5, r["fake_gap"]
    # Every rank ends with the same metrics (the gate reads them).
    for r in per_rank[1:]:
        for k in r["d"]:
            np.testing.assert_array_equal(np.asarray(r["d"][k]), np.asarray(per_rank[0]["d"][k]))


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]])
def test_tp_steps_match_the_jax_mesh(runs, name):
    """Against the JAX package's D and G steps on make_mesh(n=4, tp=2)."""
    st_g, jdm, _, per_rank = runs[name]
    out = convert.train_state_to_jax(per_rank[0]["state"])
    assert l2rel(st_g.d_params, out["d_params"]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert l2rel(st_g.g_params, out["g_params"]) < 2e-3
    assert l2rel(st_g.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    tdm = per_rank[0]["d"]
    assert sorted(tdm) == sorted(jdm)
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty"):
        if k in jdm:
            np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("name", [n for n in CASES if "fused" in n])
def test_fused_noise_of_the_slices_is_the_one_device_draw(runs, name):
    """The fused route's noise (K6's plain version at each slice's counter
    base, the small leaves' normals cut) of every rank's slices, bit for
    bit the same elements of the one-device draw; and it moves the step
    (sigma > 0), which the comparison with one device above holds."""
    (_, _, _, tb, st), per_rank = runs[name][2], runs[name][3]
    assert per_rank[0]["noise"] is not None
    ranks = CASES[name][2]
    leaves = [st.d_params[k] for k in tb.d_leaves]
    stds = torch.tensor(gops.noise_stds(len(leaves), tb.sigma, st.clipping, tb.per_layer))
    fused = gops.draw_fused_noise(torch.Generator().manual_seed(1), leaves, stds)
    whole = gops.weighted_sum_fused_noise(
        {k: torch.zeros((NOISE_ROWS,) + tuple(tb.d_shapes[k])) for k in tb.d_leaves},
        torch.zeros(len(leaves), NOISE_ROWS), fused)
    n_cut = 0
    for rank, r in enumerate(per_rank):
        m = MeshContext(world=ranks, rank=rank, tp=2)
        for k in tb.d_leaves:
            want = m.cut(k, tb.d_shapes[k], whole[k], data=False)
            assert torch.equal(r["noise"][k], want), (rank, k)
            n_cut += tuple(want.shape) != tuple(tb.d_shapes[k])
    assert n_cut >= len(per_rank) and float(stds.max()) > 0


def test_k6_plain_at_a_base_is_the_whole_leaf_draw():
    """``weighted_sum_noise_plain`` on a slice of the columns at counter base
    b equals those columns of the whole leaf's, bit for bit (the noise
    included), at bases past 2^32 too."""
    g = torch.Generator().manual_seed(4)
    p = 3 * 4099
    g2d = torch.randn(5, p, generator=g)
    w = torch.rand(5, generator=g)
    seed = torch.tensor(0x123456789ABCDEF, dtype=torch.int64)
    whole = pallas_clip.weighted_sum_noise_plain(g2d, w, seed, 0.7)
    for lo, hi in ((0, 4099), (4099, 8198), (8198, p), (1, 2)):
        part = pallas_clip.weighted_sum_noise_plain(g2d[:, lo:hi], w, seed, 0.7, base=lo)
        assert torch.equal(part, whole[lo:hi]), (lo, hi)
    # Past 2^32 the counter's high word carries the index's high bits.
    q = torch.arange(2 ** 32 - 4, 2 ** 32 + 4, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    words = pallas_clip.philox4x32_10((q & 0xFFFFFFFF, q >> 32, zero, zero),
                                      (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))
    assert torch.equal(pallas_clip.philox_normal(seed, 8, base=2 ** 32 - 4),
                       pallas_clip.normal_from_bits(words[0], words[1]))
    leaf = torch.randn(5, 8, 3, 2, generator=g)
    assert torch.equal(pallas_clip.leaf_weighted_sum_noise(leaf[:, 4:].contiguous(), w, seed,
                                                           0.5, base=24),
                       pallas_clip.leaf_weighted_sum_noise(leaf, w, seed, 0.5)[4:])


# ---------------- refusals, saves and resume ----------------

@pytest.mark.parametrize("flag,argv", [
    ("--tp with -dpm is", ["-dpm", "is"]),
    ("--tp with -dpm tm / sv", ["-dpm", "sv"]),
    ("--tp with --poisson", ["-dpm", "gc", "--poisson", "true"]),
    ("--tp with adaptive clipping", ["-dpm", "gc", "-gcm", "adaptive", "-pss", "20"]),
    ("--tp with -pupd false", ["-dpm", "gc", "--penalty", "WGAN-GP", "-pupd", "false"]),
    ("--tp with --penalty DRAGAN", ["--penalty", "DRAGAN"]),
    ("--tp with --backprop_clip", ["-dpm", "gc", "--backprop_clip", "true"])])
def test_engines_refused_under_tp(tmp_path, monkeypatch, flag, argv):
    """None of the engines that --tp once refused (``flag``, their old
    refusal) is refused now: each parses under --mesh_shape 2 --tp 2 and
    builds the last rank's Trainer, whose D state holds that rank's slices
    (tests/test_torch_tensor_axis_engines.py runs their steps)."""
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 8)
    base = ["MNIST", "--conditional", "-tss", "80", "-bs", "8", "--platform", "cpu", "-o",
            str(tmp_path)]
    opt = toptions.parse(base + argv + ["--mesh_shape", "2", "--tp", "2"])
    assert not hasattr(toptions, "_NOT_PORTED") and opt.tp == 2
    tr = Trainer(opt, mesh=MeshContext(world=2, rank=1, tp=2))
    assert tuple(tr.state.d_params["lin1.weight"].shape) == (64, 794)
    toptions.parse(base + argv)           # each runs without the tensor axis


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
CLI = ["MNIST", "-tss", "96", "-bs", "24", "--manual_seed", "5", "-dpm", "gc", "--conditional",
       "--log_every", "100000", "--sample_every", "4", "--save_every", "1", "--sample_num",
       "10", "--pallas_epoch", "false", "--platform", "cpu"]


def _cli(*argvs, timeout=150):
    procs = [subprocess.Popen([sys.executable, "-m", "csl_gan_tpu_torch.train", *a], cwd=REPO,
                              env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for a in argvs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a training run timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _saves(out_dir, epoch):
    return {f: checkpoint._load(os.path.join(out_dir, "saves", f"{f}-{epoch}"))
            for f in ("G", "D")}


def _flat(tree, pre=""):
    if not isinstance(tree, dict):
        return {pre: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}/{k}"))
    return out


def test_tp_saves_resume_and_grids(tmp_path):
    """Through the CLI on 2 ranks at --tp 2: the saves have the one-process
    run's format (keys, shapes, dtypes) and values within its bound (rtol
    1e-3, atol 1e-4, JAX test_multihost.py's); 1 + 1 resumed epochs equal 2
    bit for bit; rank 0 writes the grids."""
    one, tp1, tp2 = (str(tmp_path / d) for d in ("one", "tp1", "tp2"))
    tp = ["--mesh_shape", "2", "--tp", "2"]
    outs = _cli(CLI + ["-ne", "1", "-o", one], CLI + tp + ["-ne", "1", "-o", tp1],
                CLI + tp + ["-ne", "2", "-o", tp2])
    assert "torch.distributed: 2 rank(s) as (data, model) = (1, 2) over gloo on the CPU." \
        in outs[1]
    a, b = _saves(tp1, 1), _saves(one, 1)
    for f in ("G", "D"):
        fa, fb = _flat(a[f]), _flat(b[f])
        assert fa.keys() == fb.keys()
        for k, v in fb.items():
            if isinstance(v, np.ndarray):
                assert (fa[k].shape, fa[k].dtype) == (v.shape, v.dtype), f + k
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(fa[k], v, rtol=1e-3, atol=1e-4, err_msg=f + k)
    assert sorted(os.listdir(os.path.join(tp1, "samples")))
    _cli(["MNIST", "-rp", tp1, "-re", "1", "-ne", "2", "-ka", "n_epochs", "--platform",
          "cpu"])
    for f in ("G-2", "D-2"):
        with open(os.path.join(tp1, "saves", f), "rb") as x, \
                open(os.path.join(tp2, "saves", f), "rb") as y:
            assert x.read() == y.read(), f


def _term_run(out):
    """The --tp 2 CLI run of the SIGTERM test on 2 spawned ranks: (process,
    its output lines so far, set at its "=== Epoch 2" line, the reader)."""
    p = subprocess.Popen([sys.executable, "-m", "csl_gan_tpu_torch.train", *CLI, "--mesh_shape",
                          "2", "--tp", "2", "-ne", "400", "--log_every", "96", "--sample_every",
                          "100000", "--save_every", "1000", "-o", out], cwd=REPO, env=ENV,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         start_new_session=True)
    lines, seen = [], threading.Event()

    def read():
        for raw in iter(p.stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))
            if lines[-1].startswith("=== Epoch 2 "):
                seen.set()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    return p, lines, seen, t


def test_sigterm_under_tp_stops_the_ranks_after_one_epoch_and_saves(tmp_path):
    """SIGTERM to a --tp 2 run on 2 spawned ranks: the ranks finish the
    same epoch (the stop flag is all-reduced over the world), rank 0 saves
    whole leaves and the run exits 0. The run is started once: its ranks
    meet on a store that the parent holds before they start
    (tests/test_torch_rendezvous.py), so no other socket can take its port."""
    out = str(tmp_path / "term")
    p, lines, seen, t = _term_run(out)
    try:
        # Epoch 2 within 120 s, or the run's end (it failed before it).
        t_end = time.monotonic() + 120
        while not seen.wait(0.2) and p.poll() is None and time.monotonic() < t_end:
            pass
        if not seen.is_set():
            t.join(10)          # the whole output of a run that ended before it
        assert seen.is_set(), "".join(lines[-20:])
        p.send_signal(signal.SIGTERM)
        p.wait(120)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    t.join(10)
    text = "".join(lines)
    assert p.returncode == 0, text[-3000:]
    stopped = [ln for ln in lines if ln.startswith("Preempted after epoch ")]
    assert len(stopped) == 1, text[-3000:]
    epoch = int(stopped[0].split()[3].rstrip(";"))
    assert sorted(os.listdir(os.path.join(out, "saves"))) == [f"D-{epoch + 1}", f"G-{epoch + 1}"]
