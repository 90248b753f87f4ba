"""The D-step engines beside gc's routes on the tensor axis (``--tp``), over
gloo CPU ranks: -dpm is (flat, ``-ispp true``, ``-issm moving-avg-pl``, and
on the DCResNet with its BatchNorm G), tm, sv, ``--poisson``, adaptive
clipping, ``-pupd false`` on the fused route, DRAGAN and
``--backprop_clip`` (gc and is), each as one D step and one G step against
the port's one device and against the JAX package's step on
``make_mesh(n=4, tp=2)``.

The harness is tests/test_torch_tensor_axis.py's: every case starts from the
JAX package's initial state with Adam moments of a run in progress, every
JAX draw is handed to the port (z, the engine's noise, the penalty's draws,
the Poisson mask, the adaptive batch), and the ranks run
tests/torch_parallel_cases.py ``steps`` on their rows and channels: one
subprocess for the 2-rank layout (tp 2) and one for the 4-rank layout (dp 2
x tp 2), every case of a layout in it. The GroupNorm DCResNet cases give
the D step the one-device G's fakes (the data axis's known sensitivity, see
test_torch_tensor_axis.py).

Tolerances. Against the port's one device, in both layouts: every param,
Adam moment and metric within rtol 5e-4 and atol 5e-6, atol 5e-5 on the
DCResNet cases (test_torch_tensor_axis.py's). Against the JAX mesh on the
4-rank layout: params and mu 2e-3 in normalized l2, nu 4e-3, the loss
metrics and the is sensitivity 1e-4 relative. The fused route's noise is
K6's Philox stream, not a JAX draw, so the ``-pupd false`` case meets the
JAX step at sigma 0; its logged batch penalty is taken on the per-sample
draws (``d_core``), which JAX draws apart, so that metric is held to one
device only.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.parallel import make_mesh
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.parallel import launch
from csl_gan_tpu_torch.parallel.mesh import MeshContext
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.steps import StepBuilder
from test_torch_sharded_steps import _noise_tree, _warm, l2rel
from torch_conditional_cases import STEP_DCRN, STEP_VANILLA, as_j, as_t, as_y
from torch_dp_surface_cases import penalty_draws, ps_penalty_draws
from torch_parallel_cases import run_ranks

BS = 8
COND = ["--conditional"]
V = STEP_VANILLA + COND
DCRN = STEP_DCRN + COND + ["--aux_loss_type", "wasserstein"]
BPC = ["-bpc", "true", "--bpc_back_clip_param", "0.02", "--bpc_forward_clip_param", "8"]
# name: (argv, engine, atol against one device, what the 4-rank layout adds
# to argv for the JAX comparison)
CASES = {
    "is": (V + ["-dpm", "is"], "is", 5e-6, []),
    "is-ispp": (V + ["-dpm", "is", "-ispp", "true"], "is", 5e-6, []),
    "is-moving-avg-pl": (V + ["-dpm", "is", "-issm", "moving-avg-pl"], "is", 5e-6, []),
    "is-dcrn-batchnorm": (DCRN + ["-dpm", "is"], "is", 5e-5, []),
    "tm": (V + ["-dpm", "tm", "--tm_m", "1"], "tm", 5e-6, []),
    "sv": (V + ["-dpm", "sv"], "sv", 5e-6, []),
    "poisson": (V + ["-dpm", "gc", "--poisson", "true"], "gc", 5e-6, []),
    "adaptive": (V + ["-dpm", "gc", "-gcm", "adaptive", "-pss", "20"], "gc", 5e-6, []),
    "adaptive-dcrn": (DCRN + ["-dpm", "gc", "-gcm", "adaptive"], "gc", 5e-5, []),
    "pupd-false-fused": (V + ["-dpm", "gc", "--penalty", "WGAN-GP", "-pupd", "false",
                              "--pallas", "true"], "gc", 5e-6, ["--sigma", "0"]),
    "dragan-dcrn": ([("DRAGAN" if a == "WGAN-GP" else a) for a in DCRN] + ["-dpm", "gc"], "gc",
                    5e-5, []),
    "bpc-gc": (V + ["-dpm", "gc"] + BPC, "gc", 5e-6, []),
    "bpc-is": (V + ["-dpm", "is"] + BPC, "is", 5e-6, []),
}
LAYOUTS = (2, 4)


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port_state(st):
    """The port's copy of a JAX TrainState, with its is scaling vector."""
    h = jax.device_get(st)
    return convert.train_state_from_jax(
        h.d_params, h.g_params,
        (h.d_opt_state[0].mu, h.d_opt_state[0].nu, int(h.d_opt_state[0].count)),
        (h.g_opt_state[0].mu, h.g_opt_state[0].nu, int(h.g_opt_state[0].count)),
        h.clipping, scaling_vec=h.scaling_vec, g_batch_stats=h.g_batch_stats)


def _case(tmp, name, argv, engine):
    """(the port's payload for the ranks, a function that runs the JAX D and
    G steps on make_mesh(4, tp=2) and returns the JAX state after them and
    the JAX D metrics)."""
    jopt = options.parse(argv + ["-o", str(tmp / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = _warm(jb.init_state(Gv, Dv), 3)
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp / "port")])
    tb = StepBuilder(topt, *init_models(topt, torch.device("cpu")))
    ts = _port_state(st)

    dcr = "DeepConvResNet" in argv
    n = tb.poisson_cap if tb.poisson else BS
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0 if dcr else 0.0, 1, (n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    valid = None
    if tb.poisson:
        valid = (rng.uniform(size=n) < 0.6).astype(np.float32)
        valid[:2] = 1.0
    # The per-sample penalty's batch value is logged on the real batch.
    pen_x = (x if tb.ps_pen else rng.uniform(-1, 1, x.shape).astype(np.float32)) \
        if tb.penalty_types else None
    ax = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if tb.adaptive else x
    ay = rng.integers(0, 10, BS).astype(np.int32) if tb.adaptive else y
    d_key = jax.random.PRNGKey(31)

    def jax_steps():
        ctx = make_mesh(n=4, tp=2)
        jb._constrain_state = ctx.constrain_state
        jst = ctx.put_state(st)
        jx, jy = (ctx.put_batch if n % 2 == 0 else lambda *a: ctx.put_replicated(a))(
            jnp.asarray(x), jnp.asarray(y))
        jpen = (as_j(pen_x), as_j(y))
        if engine == "gc":
            st_d, jdm = jax.jit(jb._d_step_gc)(jst, jx, jy, *jpen, jnp.asarray(ax),
                                               jnp.asarray(ay), d_key, as_j(valid))
        elif engine == "is":
            st_d, jdm = jax.jit(jb._d_step_is)(jst, jx, jy, *jpen, d_key)
        else:
            st_d, jdm = jax.jit(jb._d_step_tmsv)(jst, jx, jy, *jpen, d_key)
        return jax.device_get(jax.jit(jb._g_step)(st_d, jax.random.PRNGKey(17))[0]), jdm

    kd = key_rows(d_key, 3)
    d = dict(x=as_t(x), y=as_y(y), z=as_t(jb.gen_z(kd[0], n)), use_dp=True)
    if tb.penalty_types:
        draws = (ps_penalty_draws(kd[2], tb.penalty_types, x.shape) if tb.ps_pen
                 else penalty_draws(kd[2], tb.penalty_types, pen_x.shape))
        d.update(pen_x=as_t(pen_x), pen_y=as_y(y), alphas=draws)
    if valid is not None:
        d["valid"] = as_t(valid)
    if tb.adaptive:
        d.update(ax=as_t(ax), ay=as_y(ay))
    if tb.fused_route:
        leaves = [ts.d_params[k] for k in tb.d_leaves]
        stds = torch.tensor(gops.noise_stds(len(leaves), tb.sigma, ts.clipping, tb.per_layer))
        d["fused"] = gops.draw_fused_noise(torch.Generator().manual_seed(1), leaves, stds)
    else:
        tree = _noise_tree(jb, st, kd[1], engine, std_one=tb.adaptive)
        d["noise"] = [tree[k] for k in tb.d_leaves]
    if dcr and tb.penalty_types and not tb.g_has_bn:
        d["fake"] = tb.fakes(ts.g_params, d["z"], d["y"])
    kg = key_rows(jax.random.PRNGKey(17), 2)
    g = (as_t(jb.gen_z(kg[0], BS)), as_y(jb.gen_y(kg[1], BS)))
    return dict(name=name, argv=argv, fsdp=False, state=ts, d=d, g=g, noise_rows=None), \
        jax_steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(name, ranks): (JAX state, JAX metrics, one-device (state, D metrics,
    G metrics), the ranks' results by rank)}: every case on 2 ranks (tp 2)
    and on 4 (dp 2 x tp 2), the JAX mesh beside the 4-rank layout. The rank
    subprocesses run while this process takes the JAX and one-device
    steps."""
    tmp = tmp_path_factory.mktemp("tp_engines")
    out, payloads, later = {}, {r: [] for r in LAYOUTS}, []
    for name, (argv, engine, _, jax_extra) in CASES.items():
        built = {}
        for ranks in LAYOUTS:
            case_argv = argv + (jax_extra if ranks == 4 else [])
            if tuple(case_argv) not in built:
                built[tuple(case_argv)] = _case(tmp / f"{name}-{ranks}", name, case_argv,
                                                engine)
            payload, jax_steps = built[tuple(case_argv)]
            payloads[ranks].append(payload)
            later.append((name, ranks, case_argv, payload, jax_steps if ranks == 4 else None))
    threads, errors = [], []
    for ranks, cases in payloads.items():
        path = tmp / f"payload{ranks}.pt"
        torch.save(cases, path)
        (tmp / f"ranks{ranks}").mkdir()

        def run(ranks=ranks, path=path):
            try:
                run_ranks("steps", ranks, path, tmp / f"ranks{ranks}", timeout=300, tp=2)
            except Exception as e:          # re-raised below, in the fixture
                errors.append(e)

        threads.append(threading.Thread(target=run))
        threads[-1].start()
    one = {}
    for name, ranks, case_argv, payload, jax_steps in later:
        st_g, jdm = jax_steps() if jax_steps else (None, None)
        if id(payload) not in one:
            topt = toptions.parse(case_argv + ["--platform", "cpu", "-o",
                                               str(tmp / f"{name}-{ranks}" / "one")])
            tb = StepBuilder(topt, *init_models(topt, torch.device("cpu")))
            s1, dm1 = tb.d_core(payload["state"], **payload["d"])
            s1, gm1 = tb.g_core(s1, *payload["g"])
            one[id(payload)] = (s1, dm1, gm1)
        out[(name, ranks)] = [st_g, jdm, one[id(payload)]]
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for ranks, cases in payloads.items():
        per_rank = [torch.load(tmp / f"ranks{ranks}" / f"rank{r}.pt", weights_only=False)
                    for r in range(ranks)]
        for case in cases:
            out[(case["name"], ranks)].append([p[case["name"]] for p in per_rank])
    return out


@pytest.mark.parametrize("ranks", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_one_device(runs, name, ranks):
    _, _, (s1, dm1, gm1), per_rank = runs[(name, ranks)]
    atol = CASES[name][2]
    got = per_rank[0]["state"]
    for f in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu", "g_batch_stats"):
        for k in getattr(s1, f):
            np.testing.assert_allclose(getattr(got, f)[k].numpy(), getattr(s1, f)[k].numpy(),
                                       rtol=5e-4, atol=atol, err_msg=f"{name} {f}[{k}]")
    if isinstance(s1.scaling_vec, torch.Tensor):
        np.testing.assert_allclose(got.scaling_vec.numpy(), s1.scaling_vec.numpy(), rtol=5e-4,
                                   atol=atol)
    if isinstance(s1.clipping, torch.Tensor):
        np.testing.assert_allclose(got.clipping.numpy(), s1.clipping.numpy(), rtol=5e-4)
    assert (got.d_count, got.g_count) == (s1.d_count, s1.g_count) == (11, 11)
    for dm, m1 in ((per_rank[0]["d"], dm1), (per_rank[0]["g"], gm1)):
        assert sorted(dm) == sorted(m1)
        for k in m1:
            np.testing.assert_allclose(np.asarray(dm[k]), np.asarray(m1[k]), rtol=5e-4,
                                       atol=atol, err_msg=k)
    if per_rank[0]["fake_gap"] is not None:
        for r in per_rank:
            assert r["fake_gap"] < 1e-5, r["fake_gap"]
    # Every rank held channel slices and ends with the same metrics.
    for r in per_rank:
        held = r["held"]["d_params"]
        assert any(held[k][0] * 2 == s1.d_params[k].shape[0] for k in held), name
        for k in r["d"]:
            np.testing.assert_array_equal(np.asarray(r["d"][k]),
                                          np.asarray(per_rank[0]["d"][k]))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_the_jax_mesh(runs, name):
    """The 4-rank layout (dp 2 x tp 2) against the JAX package's D and G
    steps on make_mesh(n=4, tp=2)."""
    st_g, jdm, _, per_rank = runs[(name, 4)]
    out = convert.train_state_to_jax(per_rank[0]["state"])
    assert l2rel(st_g.d_params, out["d_params"]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert l2rel(st_g.g_params, out["g_params"]) < 2e-3
    assert l2rel(st_g.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    tdm = per_rank[0]["d"]
    assert sorted(tdm) == sorted(jdm)
    keys = ["d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "is_sens"]
    if "pupd-false" not in name:
        keys.append("penalty")
    for k in keys:
        if k in jdm:
            np.testing.assert_allclose(np.asarray(tdm[k], np.float64),
                                       np.asarray(jdm[k], np.float64), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    if "clipping" in jdm and "adaptive" in name:
        np.testing.assert_allclose(np.asarray(tdm["clipping"]), np.asarray(jdm["clipping"]),
                                   rtol=1e-4)


# ---------------- the CLI ----------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
CLI = ["MNIST", "-tss", "96", "-bs", "24", "--manual_seed", "5", "--conditional",
       "--log_every", "100000", "--sample_every", "100000", "-ne", "1", "--platform", "cpu"]


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


def _flat(tree, pre=""):
    if not isinstance(tree, dict):
        return {pre: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}/{k}"))
    return out


@pytest.mark.parametrize("engines,argv", [
    ("is + backprop clipping", ["-dpm", "is", "-bpc", "true"]),
    ("Poisson + adaptive clipping", ["-dpm", "gc", "--poisson", "true", "-gcm", "adaptive",
                                     "-pss", "48"])])
def test_tp_cli_run_saves_as_one_process(tmp_path, engines, argv):
    """One epoch through the CLI on 2 gloo ranks at --tp 2 and in one
    process: the saves have the one-process run's format (keys, shapes,
    dtypes) and values within its bound (rtol 1e-3, atol 1e-4,
    test_torch_tensor_axis.py's)."""
    one, tp = str(tmp_path / "one"), str(tmp_path / "tp")
    outs = _cli(CLI + argv + ["-o", one],
                CLI + argv + ["--mesh_shape", "2", "--tp", "2", "-o", tp])
    assert "torch.distributed: 2 rank(s) as (data, model) = (1, 2) over gloo on the CPU." \
        in outs[1], engines
    for f in ("G", "D"):
        fa = _flat(checkpoint._load(os.path.join(tp, "saves", f"{f}-1")))
        fb = _flat(checkpoint._load(os.path.join(one, "saves", f"{f}-1")))
        assert fa.keys() == fb.keys()
        for k, v in fb.items():
            if isinstance(v, np.ndarray):
                assert (fa[k].shape, fa[k].dtype) == (v.shape, v.dtype), f + k
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(fa[k], v, rtol=1e-3, atol=1e-4, err_msg=f + k)


# ---------------- every engine builds its Trainer under --tp ----------------

@pytest.mark.parametrize("argv", [
    ["-dpm", "is"], ["-dpm", "tm"], ["-dpm", "sv"], ["-dpm", "gc", "--poisson", "true"],
    ["-dpm", "gc", "-gcm", "adaptive", "-pss", "20"],
    ["-dpm", "gc", "--penalty", "WGAN-GP", "-pupd", "false"], ["--penalty", "DRAGAN"],
    ["-dpm", "gc", "--backprop_clip", "true"]])
def test_engine_trainer_builds_on_dp_x_tp(tmp_path, monkeypatch, argv):
    """Each engine parses under --mesh_shape 4 --tp 2 (dp 2 x tp 2) and
    builds the last rank's Trainer: its D state holds that rank's slices
    (test_torch_tensor_axis.py builds them at --tp 2 on 2 ranks)."""
    world = 4
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 8)
    opt = toptions.parse(["MNIST", "--conditional", "-tss", "80", "-bs", "8", "--platform",
                          "cpu", "--mesh_shape", str(world), "--tp", "2", "-o",
                          str(tmp_path)] + argv)
    assert opt.tp == 2
    tr = Trainer(opt, mesh=MeshContext(world=world, rank=world - 1, tp=2))
    assert tr.builder.d_sharded == ("lin1.weight",)
    assert tuple(tr.state.d_params["lin1.weight"].shape) == (64, 794)
    assert tuple(tr.state.d_mu["lin1.weight"].shape) == (64, 794)
