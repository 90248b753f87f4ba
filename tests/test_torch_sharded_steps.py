"""One D step and one G step of the port over gloo CPU ranks (the data axis,
csl_gan_tpu_torch/parallel), against the same steps of the port on one
device and of the JAX package on ``make_mesh(n)``, on the CPU.

Each case starts from the JAX package's initial state with Adam moments of
a run in progress (count 10, random moments: the first Adam step from zero
moments moves each param by lr times the sign of its gradient, which a
rounding-level change flips where the gradient is ~0), converted to the
port. Every JAX draw is recomputed from the step's keys and handed to the
port (z, the DP noise with sigma > 0, the penalty's draws; the G step's z
and labels), as tests/torch_dp_surface_cases.py does. The port's ranks
(tests/torch_parallel_cases.py ``steps``, one subprocess for the 2-rank
cases and one for the 4-rank case) take the global inputs and keep their
rows.

Cases: gc on the vanilla ghost route (noise on), the narrow DCResNet
conv-ghost route with WGAN-GP on mean samples, the fused K6 route (plain
version; noise on, and at sigma 0 for the JAX comparison, whose noise is
JAX's own), is with the BatchNorm G and the penalty, tm, sv, the
non-private DCResNet step (BatchNorm G), Poisson (a 31-row buffer cut
16 / 15), adaptive clipping on a public batch, --fsdp against replicated,
and the ghost route on 4 ranks. The GroupNorm DCResNet cases give the D
step the one-device G's fakes, each rank its rows, and hold each rank's own
G forward of its rows to them at 1e-5 alone: the G forward of 4 rows and of
8 rounds differently (~1e-6), and through a leaky-ReLU mask of D's input
gradient that moved one penalty row by 2e-5 relative (the known
sensitivity of ROADMAP Queue 3; tests/test_torch_conditional_engines.py
holds the BatchNorm fakes the same way).

Tolerances. Against the port's one-device step: every param, Adam moment
and metric within rtol 5e-4, atol 5e-6 (tests/test_sharding.py's; the runs
differ by the reduction order of the sums only). Against the JAX step on
the mesh, those of the port's single-device parity tests
(tests/torch_conditional_cases.py ``assert_d_step``): params and mu within
2e-3 in normalized l2, nu 4e-3, the loss metrics within 1e-4 relative;
each leaf with 1e-6 sqrt(size) of slack, as the conv biases before a
BatchNorm have a gradient that is zero up to rounding and moments of
rounding noise in both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.parallel import make_mesh
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training.steps import StepBuilder
from torch_conditional_cases import STEP_DCRN, STEP_VANILLA, as_j, as_t, as_y
from torch_dp_surface_cases import penalty_draws
from torch_parallel_cases import run_ranks

os.makedirs("output", exist_ok=True)

BS = 8
COND = ["--conditional"]
DCRN = STEP_DCRN + COND + ["--aux_loss_type", "wasserstein"]
# name: (argv, engine, ranks, fsdp, noise compared with the JAX step)
CASES = {
    "gc-ghost": (STEP_VANILLA + COND + ["-dpm", "gc"], "gc", 2, False, True),
    "gc-conv-ghost": (DCRN + ["-dpm", "gc"], "gc", 2, False, True),
    "gc-fused": (STEP_VANILLA + COND + ["-dpm", "gc", "--pallas", "true",
                                        "--grad_clip_split", "false"], "gc", 2, False, False),
    "gc-fused-sigma0": (STEP_VANILLA + COND + ["-dpm", "gc", "--pallas", "true",
                                               "--grad_clip_split", "false", "--sigma", "0"],
                        "gc", 2, False, True),
    "is-batchnorm": (DCRN + ["-dpm", "is"], "is", 2, False, True),
    "tm": (STEP_VANILLA + COND + ["-dpm", "tm", "--tm_m", "1"], "tm", 2, False, True),
    "sv": (STEP_VANILLA + COND + ["-dpm", "sv"], "sv", 2, False, True),
    "plain-batchnorm": (DCRN, "plain", 2, False, True),
    "poisson": (STEP_VANILLA + COND + ["-dpm", "gc", "--poisson", "true"], "gc", 2, False,
                True),
    "adaptive": (STEP_VANILLA + COND + ["-dpm", "gc", "-gcm", "adaptive", "-pss", "20"], "gc",
                 2, False, True),
    "fsdp": (DCRN + ["-dpm", "gc"], "gc", 2, True, True),
    "gc-ghost-4-ranks": (STEP_VANILLA + COND + ["-dpm", "gc"], "gc", 4, False, True),
}


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _warm(st, seed):
    """The JAX state with Adam moments of a run in progress."""
    rng = np.random.default_rng(seed)

    def warm(s):
        mu = jax.tree_util.tree_map(
            lambda l: jnp.asarray(rng.normal(0, 1e-2, l.shape), jnp.float32), s.mu)
        nu = jax.tree_util.tree_map(
            lambda l: jnp.asarray(rng.uniform(5e-5, 1.5e-4, l.shape), jnp.float32), s.nu)
        return s._replace(count=jnp.asarray(10, s.count.dtype), mu=mu, nu=nu)

    return st.replace(d_opt_state=(warm(st.d_opt_state[0]),) + tuple(st.d_opt_state[1:]),
                      g_opt_state=(warm(st.g_opt_state[0]),) + tuple(st.g_opt_state[1:]))


def _port_state(st):
    h = jax.device_get(st)
    return convert.train_state_from_jax(
        h.d_params, h.g_params,
        (h.d_opt_state[0].mu, h.d_opt_state[0].nu, int(h.d_opt_state[0].count)),
        (h.g_opt_state[0].mu, h.g_opt_state[0].nu, int(h.g_opt_state[0].count)),
        h.clipping, g_batch_stats=h.g_batch_stats)


def _noise_tree(jb, st, key, engine, std_one):
    leaves, treedef = jax.tree_util.tree_flatten(st.d_params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    if engine == "is":
        tree = jgops.add_gaussian_noise(key, zeros, 1.0, jnp.ones(len(leaves)), per_layer=True)
    elif engine == "gc":
        tree = jgops.add_gaussian_noise(key, zeros, 1.0 if std_one else jb.sigma,
                                        1.0 if std_one else st.clipping,
                                        per_layer=jb.per_layer)
    else:
        keys = jax.random.split(key, len(leaves))
        draw = (lambda k, s: jax.random.t(k, 3.0, s)) if engine == "tm" else jax.random.normal
        tree = jax.tree_util.tree_unflatten(treedef,
                                            [draw(k, l.shape) for k, l in zip(keys, leaves)])
    return convert.params_from_jax(jax.device_get(tree), "D")


def _case(tmp, name):
    """(the JAX state after the D and G steps on make_mesh(ranks), the JAX D
    metrics, the port's payload for the ranks)."""
    argv, engine, ranks, fsdp, _ = CASES[name]
    jopt = options.parse(argv + ["-o", str(tmp / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = _warm(jb.init_state(Gv, Dv), 3)
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    ts = _port_state(st)

    dcresnet = "DeepConvResNet" in argv
    n = tb.poisson_cap if tb.poisson else BS
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    valid = None
    if tb.poisson:
        valid = (rng.uniform(size=n) < 0.6).astype(np.float32)
        valid[:2] = 1.0
    pen_x = rng.uniform(-1, 1, x.shape).astype(np.float32) if tb.penalty_types else None
    ax = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if tb.adaptive else x
    ay = rng.integers(0, 10, BS).astype(np.int32) if tb.adaptive else y

    ctx = make_mesh(n=ranks)
    sharded = n % ranks == 0
    jst = ctx.put_replicated(st)
    jx, jy = (ctx.put_batch(jnp.asarray(x), jnp.asarray(y)) if sharded
              else ctx.put_replicated((jnp.asarray(x), jnp.asarray(y))))
    jpen = (as_j(pen_x), as_j(y))
    d_key = jax.random.PRNGKey(31)
    if engine == "gc":
        st_d, jdm = jax.jit(jb._d_step_gc)(jst, jx, jy, *jpen, jnp.asarray(ax), jnp.asarray(ay),
                                           d_key, as_j(valid))
    elif engine == "is":
        st_d, jdm = jax.jit(jb._d_step_is)(jst, jx, jy, *jpen, d_key)
    elif engine in ("tm", "sv"):
        st_d, jdm = jax.jit(jb._d_step_tmsv)(jst, jx, jy, *jpen, d_key)
    else:
        st_d, jdm = jax.jit(jb._d_step_plain)(jst, jx, jy, *jpen, d_key)
    kd = key_rows(d_key, 2 if engine == "plain" else 3)
    d = dict(x=as_t(x), y=as_y(y), z=as_t(jb.gen_z(kd[0], n)), use_dp=engine != "plain")
    if tb.penalty_types:
        d.update(pen_x=as_t(pen_x), pen_y=as_y(y),
                 alphas=penalty_draws(kd[-1], tb.penalty_types, pen_x.shape))
    if valid is not None:
        d["valid"] = as_t(valid)
    if tb.adaptive:
        d.update(ax=as_t(ax), ay=as_y(ay))
    if tb.fused_route:
        leaves = [ts.d_params[k] for k in tb.d_leaves]
        stds = torch.tensor(gops.noise_stds(len(leaves), tb.sigma, ts.clipping, tb.per_layer))
        d["fused"] = gops.draw_fused_noise(torch.Generator().manual_seed(1), leaves, stds)
    elif engine != "plain":
        tree = _noise_tree(jb, st, kd[1], engine, std_one=tb.adaptive)
        d["noise"] = [tree[k] for k in tb.d_leaves]

    if dcresnet and tb.penalty_types and not tb.g_has_bn:
        d["fake"] = tb.fakes(ts.g_params, d["z"], d["y"])
    g_key = jax.random.PRNGKey(17)
    st_g, _ = jax.jit(jb._g_step)(st_d, g_key)
    kg = key_rows(g_key, 2)
    g = (as_t(jb.gen_z(kg[0], BS)), as_y(jb.gen_y(kg[1], BS)))
    return jax.device_get(st_g), jdm, dict(name=name, argv=argv, fsdp=fsdp, state=ts, d=d, g=g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX mesh, the port on one device and the port
    on its ranks: {name: (JAX state, JAX metrics, one-device (state, D
    metrics, G metrics), the ranks' results by rank)}."""
    tmp = tmp_path_factory.mktemp("sharded")
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    out, payloads = {}, {}
    for name in CASES:
        st_g, jdm, payload = _case(tmp / name, name)
        topt = toptions.parse(payload["argv"] + ["--platform", "cpu", "-o",
                                                 str(tmp / name / "one")])
        tb = StepBuilder(topt, *init_models(topt, torch.device("cpu")))
        s1, dm1 = tb.d_core(payload["state"], **payload["d"])
        s1, gm1 = tb.g_core(s1, *payload["g"])
        out[name] = [st_g, jdm, (s1, dm1, gm1)]
        payloads.setdefault(CASES[name][2], []).append(payload)
    for ranks, cases in payloads.items():
        path = tmp / f"payload{ranks}.pt"
        torch.save(cases, path)
        res_dir = tmp / f"ranks{ranks}"
        res_dir.mkdir()
        run_ranks("steps", ranks, path, res_dir, timeout=150)
        per_rank = [torch.load(res_dir / f"rank{r}.pt", weights_only=False)
                    for r in range(ranks)]
        for case in cases:
            out[case["name"]].append([p[case["name"]] for p in per_rank])
    torch.set_num_threads(old)
    return out


def l2rel(a, b):
    """The largest ||a - b|| / ||a|| over the leaves, with 1e-6 sqrt(size)
    of slack on each (see the module docstring)."""
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
        worst = max(worst, max(0.0, np.linalg.norm(x - y) - 1e-6 * np.sqrt(x.size))
                    / (np.linalg.norm(x) + 1e-30))
    return worst


def _assert_close_trees(a, b, what):
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=f"{what}[{k}]")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_one_device_and_the_jax_mesh(runs, name):
    st_g, jdm, (s1, dm1, gm1), per_rank = runs[name]
    _, engine, ranks, fsdp, vs_jax = CASES[name]
    got = per_rank[0]["state"]
    for f in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu", "g_batch_stats"):
        _assert_close_trees(getattr(got, f), getattr(s1, f), f)
    assert (got.d_count, got.g_count) == (s1.d_count, s1.g_count) == (11, 11)
    for dm, m1 in ((per_rank[0]["d"], dm1), (per_rank[0]["g"], gm1)):
        assert sorted(dm) == sorted(m1)
        for k in m1:
            np.testing.assert_allclose(np.asarray(dm[k]), np.asarray(m1[k]), rtol=5e-4,
                                       atol=5e-6, err_msg=k)
    if per_rank[0]["fake_gap"] is not None:
        for r in per_rank:
            assert r["fake_gap"] < 1e-5, r["fake_gap"]
    # Every rank ends with the same metrics (the gate reads them).
    for r in per_rank[1:]:
        for k in r["d"]:
            np.testing.assert_array_equal(np.asarray(r["d"][k]), np.asarray(per_rank[0]["d"][k]))
    if not vs_jax:
        return
    out = convert.train_state_to_jax(got)
    assert l2rel(st_g.d_params, out["d_params"]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert l2rel(st_g.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert l2rel(st_g.g_params, out["g_params"]) < 2e-3
    assert l2rel(st_g.g_opt_state[0].mu, out["g_adam"][0]) < 2e-3
    tdm = per_rank[0]["d"]
    assert sorted(tdm) == sorted(jdm)
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty",
              "is_sens"):
        if k in jdm:
            np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_noise_enters_once(runs):
    """The fused route's noise (K6's plain version, its Philox stream from
    the drawn seeds) moves the step far more than the ranks' step differs
    from the one-device step, which adds it once: noise added on every rank,
    or on none, would fail the comparison above."""
    one = runs["gc-fused"][2][0].d_params
    noisy = runs["gc-fused"][3][0]["state"].d_params
    clean = runs["gc-fused-sigma0"][2][0].d_params
    gap = max(float((noisy[k] - one[k]).abs().max()) for k in one)
    noise_scale = max(float((one[k] - clean[k]).abs().max()) for k in one)
    assert noise_scale > 100 * max(gap, 1e-7), (noise_scale, gap)


def test_fsdp_ranks_hold_shards(runs):
    """Under --fsdp each rank holds 1 / ranks of every leaf of 2^11 elements
    or more with a divisible dim (params and Adam moments, before and after
    the steps), and the rest whole; the replicated run holds every leaf
    whole. The dim is the JAX package's choice on the leaf's flax shape (a
    conv weight [O, I, kh, kw] is flax [kh, kw, I, O], a dense weight [O, I]
    flax [I, O]), mapped back to the torch dim."""
    from csl_gan_tpu.parallel.mesh import fsdp_spec
    s1 = runs["fsdp"][2][0]
    for r in runs["fsdp"][3]:
        n_sharded = 0
        for f in ("d_params", "d_mu", "g_params", "g_mu"):
            for k, shape in r["held"][f].items():
                full = tuple(getattr(s1, f)[k].shape)
                axes = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(full), tuple(range(len(full))))
                spec = tuple(fsdp_spec(tuple(full[a] for a in axes), 2))
                if spec:
                    d = axes[spec.index("data")]
                    assert shape == full[:d] + (full[d] // 2,) + full[d + 1:], (f, k)
                    n_sharded += 1
                else:
                    assert shape == full, (f, k)
        assert n_sharded >= 6
        assert r["held_after"] == r["held"]["d_mu"]
    for r in runs["gc-conv-ghost"][3]:
        assert all(shape == tuple(s1.d_mu[k].shape) for k, shape in r["held"]["d_mu"].items())
