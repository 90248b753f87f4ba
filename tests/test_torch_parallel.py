"""The port's data-axis layer (csl_gan_tpu_torch/parallel) on the CPU:

  - ``state_spec`` / ``fsdp_spec`` against the JAX package's on a table of
    shapes (tests/test_sharding.py's cases among them);
  - ``split_bounds`` / ``shard_rows`` against ``torch.tensor_split``, and the
    collectives over 2 and 3 gloo ranks on an uneven [7, 3] batch
    (tests/torch_parallel_cases.py ``collectives``): ``gather_rows`` and its
    backward, ``all_sum`` / ``all_max`` / ``broadcast`` / ``agree`` /
    ``any`` / ``all_sum_list``;
  - both differentiable sums against the one-device autograd answer: the
    loss computed alike on every rank from ``sum_replicated`` back-propagates
    the single-device gradient (``torch.distributed.nn``'s all-reduce would
    give N times it), and ``sum_distinct`` the gradient of the ranks' summed
    losses;
  - a MeshContext without a process group is the identity;
  - the options: the flags still refused, ``world_size`` and K1's gate
    (also the Trainer's, on a mesh of two and on a clamped world of one),
    ``world_size``'s clamp, ``--multihost``'s required arguments and where
    a ``--multihost`` process runs (``placement``: NCCL a card a rank, gloo
    only where this host runs more processes than it has cards).
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from csl_gan_tpu.parallel.mesh import fsdp_spec as jax_fsdp_spec
from csl_gan_tpu.parallel.mesh import state_spec as jax_state_spec
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.parallel import launch
from csl_gan_tpu_torch.parallel.mesh import MeshContext, fsdp_spec, split_bounds, state_spec
from torch_parallel_cases import run_ranks

SHAPES = [(794, 128), (5, 5, 512, 256), (128,), (), (4093, 3), (5, 5, 64, 128), (794, 129),
          (792, 129), (64, 64), (2048,), (2047,), (4, 4, 3, 64), (128, 64, 5, 5), (6272, 10),
          (10, 6272), (1, 6272), (110, 6272), (8192, 1), (3, 5, 7, 11)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_state_spec_matches_jax(shape):
    for dp, tp, fsdp in ((8, 1, True), (2, 1, True), (4, 2, True), (4, 2, False),
                         (3, 1, True), (1, 1, True), (8, 1, False)):
        assert state_spec(shape, dp, tp, fsdp) == tuple(jax_state_spec(shape, dp, tp, fsdp))
    for n in (2, 3, 4, 8):
        assert fsdp_spec(shape, n) == tuple(jax_fsdp_spec(shape, n))


def test_fsdp_spec_cases_of_test_sharding():
    """tests/test_sharding.py:107-112, on the port's copy."""
    assert fsdp_spec((794, 128), 8) == tuple(P(None, "data"))
    assert fsdp_spec((5, 5, 512, 256), 8) == tuple(P(None, None, "data", None))
    assert fsdp_spec((128,), 8) == ()
    assert fsdp_spec((), 8) == ()
    assert fsdp_spec((4093, 3), 8) == ()


@pytest.mark.parametrize("n,world", [(7, 2), (7, 3), (8, 4), (3, 4), (128, 3), (219, 2)])
def test_split_bounds_are_tensor_splits(n, world):
    t = torch.arange(n)
    parts = torch.tensor_split(t, world)
    for r in range(world):
        lo, hi = split_bounds(n, world, r)
        assert torch.equal(t[lo:hi], parts[r])
        assert torch.equal(MeshContext(world=world, rank=r).shard_rows(t), parts[r])


def test_one_device_context_is_the_identity():
    m = MeshContext()
    a = torch.randn(5, 3, requires_grad=True)
    assert m.shard_rows(a) is a and m.gather_rows(a, 5) is a and m.all_sum(a) is a
    assert m.sum_replicated(a) is a and m.sum_distinct(a) is a
    assert m.all_max(a) is a and m.broadcast(a) is a and m.gather_cols(a, 3) is a
    assert m.agree(True) and not m.any(False) and m.leaf_dim((4096, 8)) is None
    tree = {"w": torch.ones(64, 64)}
    assert m.unshard(tree, {"w": (64, 64)}) is tree and m.shard_leaf(tree["w"]) is tree["w"]


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    out = {}
    for world in (2, 3):
        d = tmp_path_factory.mktemp(f"coll{world}")
        run_ranks("collectives", world, d, timeout=90)
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_gather_rows_on_uneven_batches(collective_runs, world):
    full = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    parts = torch.tensor_split(full, world)
    w = full + 1
    for r, res in enumerate(collective_runs[world]):
        assert torch.equal(res["local"], parts[r])
        assert torch.equal(res["gathered"], full)
        lo, hi = res["bounds"]
        assert torch.equal(res["gather_grad"], w[lo:hi])


@pytest.mark.parametrize("world", [2, 3])
def test_reductions_and_host_decisions(collective_runs, world):
    a = [torch.tensor([1.0, 2.0, 3.0]) * (r + 1) for r in range(world)]
    total = sum(a)
    for r, res in enumerate(collective_runs[world]):
        assert torch.equal(res["sum"], total)
        assert torch.equal(res["max"], a[-1])
        assert torch.equal(res["bcast"], a[0])
        assert res["agree"] is True and res["any"] is True
        assert torch.equal(res["list"][0], total) and torch.equal(res["list"][1], total[:2] * 2)


@pytest.mark.parametrize("world", [2, 3])
def test_differentiable_sums_against_one_device_autograd(collective_runs, world):
    """Each rank's a_r enters s = sum_r 2 a_r; every rank computes the same
    L = sum(s^2). On one device, dL/da_r = 4 s: what ``sum_replicated``
    gives. ``sum_distinct`` gives the gradient of the ranks' losses summed,
    N L, which is what its backward's all-reduce computes (and what
    torch.distributed.nn's all_reduce would wrongly give for a replicated
    loss)."""
    a = [(torch.tensor([1.0, 2.0, 3.0]) * (r + 1)).requires_grad_(True) for r in range(world)]
    s = sum(2.0 * ar for ar in a)
    (s * s).sum().backward(retain_graph=True)
    one_device = [ar.grad.clone() for ar in a]
    for ar in a:
        ar.grad = None
    (world * (s * s).sum()).backward()
    summed = [ar.grad.clone() for ar in a]
    for r, res in enumerate(collective_runs[world]):
        assert torch.equal(res["grads"]["replicated"], one_device[r])
        assert torch.equal(res["grads"]["distinct"], summed[r])
        assert not torch.equal(res["grads"]["distinct"], one_device[r])


@pytest.mark.parametrize("flag,argv", [("--tp", ["--tp", "2"]),
                                       ("--download_mnist", ["--download_mnist"])])
def test_still_refused(tmp_path, monkeypatch, flag, argv):
    """Both flags that were once refused are ported, and nothing is refused
    any more (the refusal list is gone). The tensor axis: --tp 2 parses over
    2 ranks, and a tp that does not divide the ranks raises ValueError (JAX
    ``make_mesh``); no engine is refused under it
    (tests/test_torch_tensor_axis_engines.py). --download_mnist parses on a
    data path and, over 2 ranks, stays off K1's gate as every 2-rank run
    does (tests/test_torch_download.py fetches with it)."""
    base = ["MNIST", "--platform", "cpu", "-o", str(tmp_path)]
    if flag == "--tp":
        monkeypatch.setattr(launch.os, "cpu_count", lambda: 4)
        opt = toptions.parse(base + ["--mesh_shape", "2"] + argv)
        assert launch.tensor_axis(opt, launch.world_size(opt)) == 2
        with pytest.raises(ValueError, match="--tp 2 must divide the mesh size 3"):
            toptions.parse(base + ["--mesh_shape", "3"] + argv)
    else:
        monkeypatch.setattr(launch.os, "cpu_count", lambda: 4)
        opt = toptions.parse(base + ["-d", str(tmp_path / "data")] + argv)
        assert opt.download_mnist and opt.data_path == str(tmp_path / "data") + "/"
        opt = toptions.parse(base + ["--mesh_shape", "2"] + argv)
        assert opt.download_mnist and launch.world_size(opt) == 2
        assert not toptions._k1_path(opt)
    assert not hasattr(toptions, "_NOT_PORTED")


@pytest.mark.parametrize("argv,ranks", [([], 1), (["--mesh_shape", "1"], 1),
                                        (["--mesh_shape", "2"], 2),
                                        (["--multihost", "true", "--num_processes", "1"], 1),
                                        (["--multihost", "true", "--num_processes", "3"], 3),
                                        (["--fsdp", "true"], 1)])
def test_world_size_and_the_k1_gate(tmp_path, monkeypatch, argv, ranks):
    """K1 (the epochs runner) is the one-device path, as the JAX gate
    ``n_devices == 1`` has it; --fsdp alone asks for one rank."""
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 4)
    opt = toptions.parse(["MNIST", "--conditional", "-dpm", "gc", "--platform", "cpu",
                          "--coordinator_address", "localhost:1", "--process_id", "0",
                          "-o", str(tmp_path)] + argv)
    assert launch.world_size(opt) == ranks
    assert toptions._k1_path(opt) == (ranks == 1)


def test_the_k1_gate_reads_the_clamped_world(tmp_path, monkeypatch, capsys):
    """``--mesh_shape 2`` where one device is visible trains on one rank:
    the option-level gate and the Trainer's both take K1."""
    from csl_gan_tpu_torch.ops import pallas_epoch
    from csl_gan_tpu_torch.training.loop import Trainer
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 1)
    opt = toptions.parse(["MNIST", "--conditional", "-dpm", "gc", "-bs", "16", "-tss", "64",
                          "--platform", "cpu", "--mesh_shape", "2", "-o", str(tmp_path)])
    world = launch.world_size(opt)
    assert world == 1 and toptions._k1_path(opt)
    assert capsys.readouterr().out.count("only 1 devices are visible") == 1
    tr = Trainer(opt)
    assert pallas_epoch.supports(tr.builder, opt.use_dp, world)
    tr.close()


@pytest.mark.parametrize("platform,cards,env,rank,want", [
    ("cpu", 0, {}, 1, (None, "gloo")),
    # Two hosts with a card each, or two hosts with four: a card a rank.
    ("gpu", 1, {}, 0, (0, "nccl")),
    ("gpu", 1, {}, 1, (0, "nccl")),
    ("gpu", 4, {}, 5, (1, "nccl")),
    ("gpu", 4, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, 5, (1, "nccl")),
    # More processes than cards on this host: they share the card over gloo.
    ("gpu", 1, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 1, (0, "gloo")),
    ("gpu", 1, {"LOCAL_WORLD_SIZE": "2"}, 3, (0, "gloo")),
    ("gpu", 2, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 7, (1, "gloo")),
], ids=str)
def test_multihost_placement(platform, cards, env, rank, want):
    """A --multihost process shares a card only when its environment says
    that more processes than cards run on its host; else NCCL, the card
    ``rank % cards``."""
    assert launch.placement(platform, cards, *launch.local_layout(rank, env)) == want


def test_trainer_leaves_k1_beyond_one_rank(tmp_path):
    """The Trainer's runner gate reads the mesh's world size: the MNIST
    flagship's flags take K1 (the epochs runner) on one rank and the step
    runner on two."""
    from csl_gan_tpu_torch.training.loop import Trainer
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner
    argv = ["MNIST", "--conditional", "-dpm", "gc", "-bs", "16", "-tss", "64", "--platform",
            "cpu"]
    one = Trainer(toptions.parse(argv + ["-o", str(tmp_path / "one")]))
    two = Trainer(toptions.parse(argv + ["-o", str(tmp_path / "two")]),
                  MeshContext(world=2, rank=1))
    assert isinstance(one.runner, EpochsRunner) and isinstance(two.runner, StepRunner)
    assert two.privacy_log is None and one.privacy_log is not None
    one.close()
    two.close()


def test_world_size_clamps_to_the_visible_devices(tmp_path, capsys, monkeypatch):
    opt = toptions.parse(["MNIST", "--mesh_shape", "64", "--platform", "cpu",
                          "-o", str(tmp_path)])
    monkeypatch.setattr(launch.os, "cpu_count", lambda: 3)
    assert launch.world_size(opt) == 3
    assert "--mesh_shape 64: only 3 devices are visible; training on 3." in capsys.readouterr().out
    opt.mesh_shape = 2
    assert launch.world_size(opt) == 2


def test_multihost_needs_its_arguments(tmp_path, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    opt = toptions.parse(["MNIST", "--multihost", "true", "--platform", "cpu",
                          "-o", str(tmp_path)])
    with pytest.raises(ValueError, match="--coordinator_address, --num_processes, --process_id"):
        launch.world_size(opt)
    opt.coordinator_address, opt.num_processes, opt.process_id = "localhost:1", 2, 2
    with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
        launch.world_size(opt)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    opt.coordinator_address = opt.num_processes = opt.process_id = None
    assert launch._multihost_args(opt) == ("localhost:29500", 4, 1)


def test_fsdp_shard_and_whole_on_a_context_without_group():
    """``shard_leaf`` cuts the spec's dim; a leaf under the floor or without
    a divisible dim stays whole (the unshard side needs ranks: see
    tests/test_torch_sharded_steps.py)."""
    m = MeshContext(world=2, rank=1, fsdp=True)
    w = torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64)
    assert m.leaf_dim(w.shape) == 0
    assert torch.equal(m.shard_leaf(w), w[64:])
    assert m.shard_leaf(torch.ones(100)).shape == (100,)
    odd = torch.ones(4093, 3)
    assert m.shard_leaf(odd) is odd
    assert np.array_equal(m.shard_tree({"w": w}, {"w": (128, 64)})["w"].numpy(), w[64:].numpy())
