"""--download_mnist on more than one rank (``train.fetch_mnist_once``),
over gloo on the CPU with ``file://`` mirrors and no network:

  - ``--mesh_shape 2``: the CLI fetches the four files once, before it
    spawns the ranks, and the ranks train on them. Each rank's mirrors are
    swapped for a directory that does not exist, so a rank that fetched
    again would fail the run;
  - a ``--multihost`` pair: rank 0 fetches while rank 1, whose mirrors do
    not answer, waits; then both find the four files. With no mirror
    answering rank 0, both ranks raise its RuntimeError, and neither hangs.

The ranks run in subprocesses (this file run as a script), each with its
own timeout and one torch thread.
"""

import json
import os
import subprocess
import sys
import urllib.request
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch.distributed as dist

from csl_gan_tpu_torch import train
from csl_gan_tpu_torch.data import mnist
from csl_gan_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import write_mnist_mirror  # noqa: E402

ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
TIMEOUT_S = 90
NAMES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
         "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
ARGV = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-tss", "40", "-bs", "8",
        "-ne", "1", "--manual_seed", "3", "--log_every", "40", "--sample_every", "100000",
        "--sample_num", "4", "--platform", "cpu", "--download_mnist"]


def _counted(fetched):
    """Record every URL that urlretrieve is asked for in ``fetched``."""
    retrieve = urllib.request.urlretrieve

    def counting(url, *a, **kw):
        fetched.append(url)
        return retrieve(url, *a, **kw)
    urllib.request.urlretrieve = counting


class _Mirrorless:
    """A rank's function run with the rank's mirrors unreachable."""

    def __init__(self, fn, missing):
        self.fn, self.missing = fn, missing

    def __call__(self, opt, mesh, *args):
        mnist._MIRRORS = (self.missing,)
        return self.fn(opt, mesh, *args)


def _mesh_run(url, missing, data, out) -> None:
    """``train.main --mesh_shape 2`` with this process's mirror ``url`` and
    the ranks' ``missing``; prints the URLs this process fetched."""
    fetched = []
    _counted(fetched)
    mnist._MIRRORS = (url,)
    spawn = launch.spawn
    launch.spawn = lambda fn, world, opt, *a: spawn(_Mirrorless(fn, missing), world, opt, *a)
    train.main(ARGV + ["--mesh_shape", "2", "-d", data, "-o", out])
    print(json.dumps({"fetched": fetched}), flush=True)


def _multihost_rank(address, rank, url, missing, root) -> None:
    """One ``--multihost`` process of a pair: a fetch that no mirror
    answers, then one that rank 0's mirror ``url`` answers."""
    mesh = launch.init_multihost(Namespace(
        platform="cpu", fsdp=False, tp=1, multihost=True, coordinator_address=address,
        num_processes=2, process_id=rank))
    fetched = []
    _counted(fetched)
    try:
        mnist._MIRRORS = (missing,)
        opt = Namespace(download_mnist=True, dataset="MNIST", data_path=os.path.join(root, "none"))
        try:
            train.fetch_mnist_once(opt, mesh)
            raise AssertionError(f"rank {rank}: no mirror answered and the fetch did not raise")
        except RuntimeError as e:
            assert str(e).startswith("rank 0: --download_mnist"), str(e)
        mnist._MIRRORS = (url,) if rank == 0 else (missing,)
        opt.data_path = os.path.join(root, "data")
        train.fetch_mnist_once(opt, mesh)
        raw = os.path.join(root, "data", "MNIST", "raw")
        assert sorted(os.listdir(raw)) == sorted(n + ".gz" for n in NAMES), os.listdir(raw)
        print(json.dumps({"rank": rank, "fetched": fetched}), flush=True)
    finally:
        dist.destroy_process_group()


def _finish(procs):
    """The output of each process, each within TIMEOUT_S; each must exit 0."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError("a rank did not end within its timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _script(*args, env=ENV):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *map(str, args)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _mirror(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {}
    for (img, lbl), n in zip((NAMES[:2], NAMES[2:]), (40, 20)):
        arrays[img] = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
        arrays[lbl] = (np.arange(n) % 10).astype(np.uint8)
    return (write_mnist_mirror(tmp_path / "mirror", arrays),
            (tmp_path / "no_such_mirror").as_uri() + "/")


def _landed(raw, tmp_path):
    assert sorted(os.listdir(raw)) == sorted(n + ".gz" for n in NAMES)
    for n in NAMES:
        assert (raw / (n + ".gz")).read_bytes() == (tmp_path / "mirror" / (n + ".gz")).read_bytes()


def test_mesh_run_fetches_before_its_ranks(tmp_path):
    url, missing = _mirror(tmp_path)
    [out] = _finish([_script("mesh", url, missing, tmp_path / "data", tmp_path / "out")])
    assert "torch.distributed: 2 rank(s) over gloo on the CPU." in out
    assert out.count("Finished training.") == 1, out[-4000:]
    [line] = [ln for ln in out.splitlines() if ln.startswith('{"fetched"')]
    assert json.loads(line) == {"fetched": [url + n + ".gz" for n in NAMES]}
    _landed(tmp_path / "data" / "MNIST" / "raw", tmp_path)
    assert (tmp_path / "out" / "log.csv").exists()


def test_multihost_rank0_fetches_while_the_others_wait(tmp_path):
    url, missing = _mirror(tmp_path)
    store = launch.held_store(2)
    env = dict(ENV, **launch.AGENT_STORE_ENV)
    outs = _finish([_script("rank", f"localhost:{store.port}", r, url, missing, tmp_path,
                            env=env) for r in range(2)])
    seen = [json.loads(ln) for out in outs for ln in out.splitlines()
            if ln.startswith('{"rank"')]
    assert seen == [{"rank": 0, "fetched": [missing + NAMES[0] + ".gz"]
                     + [url + n + ".gz" for n in NAMES]},
                    {"rank": 1, "fetched": []}]
    _landed(tmp_path / "data" / "MNIST" / "raw", tmp_path)


if __name__ == "__main__":
    if sys.argv[1] == "mesh":
        _mesh_run(*sys.argv[2:])
    else:
        _multihost_rank(sys.argv[2], int(sys.argv[3]), *sys.argv[4:])
