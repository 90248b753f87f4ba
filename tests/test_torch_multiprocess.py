"""Multi-process training through the port's CLI (``python -m
csl_gan_tpu_torch.train ... --platform cpu``), the counterpart of the JAX
package's tests/test_multihost.py, over gloo on the CPU:

  - ``--mesh_shape 2`` (two ranks spawned by the CLI) and ``--multihost``
    over two OS processes meeting on a store that the test holds (torchrun's
    agent store, ``launch.AGENT_STORE_ENV``): rank 0's saves are
    held to the one-process run's at rtol 1e-3, atol 1e-4 (JAX
    test_multihost.py's bound). The one-process run takes the step runner
    (``--pallas_epoch false``): K1 is the one-device path and draws its
    stream in another order;
  - ``--fsdp true``: the saves have the single-device format (the same
    keys, shapes and dtypes, byte for byte the same layout) and values
    within the same bound, and 1 + 1 resumed epochs equal 2 bit for bit;
  - SIGTERM to one rank of a ``--multihost`` pair stops both after the same
    epoch (the all-reduced stop flag), and rank 0 saves;
  - ``python -m csl_gan_tpu_torch.parallel.dryrun 2``.

Every subprocess has its own timeout and is killed with its process group.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from csl_gan_tpu_torch.parallel import launch
from csl_gan_tpu_torch.training import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["MNIST", "-tss", "96", "-ne", "1", "-bs", "24", "--manual_seed", "5", "-dpm", "gc",
        "--conditional", "--log_every", "100000", "--sample_every", "100000",
        "--save_every", "1", "--sample_num", "4", "--pallas_epoch", "false",
        "--platform", "cpu"]
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _start(argv, env=ENV):
    return subprocess.Popen([sys.executable, "-m", "csl_gan_tpu_torch.train", *argv], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _wait(procs, timeout=120):
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
            pytest.fail("a training process timed out")
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def _run(argv, timeout=120):
    return _wait([_start(argv)], timeout)[0]


def _multihost(argv, n=2):
    """(the store the ranks meet on, the ``n`` ``--multihost`` processes).
    Hold the store until every process has ended."""
    store = launch.held_store(n)
    env = dict(ENV, **launch.AGENT_STORE_ENV)
    return store, [_start(argv + ["--multihost", "true", "--coordinator_address",
                                  f"localhost:{store.port}", "--num_processes", str(n),
                                  "--process_id", str(i)], env) for i in range(n)]


def _flat(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
    else:
        out[pre] = tree
    return out


def _saves(out_dir, epoch=1):
    return {f: _flat(checkpoint._load(os.path.join(out_dir, "saves", f"{f}-{epoch}")))
            for f in ("G", "D")}


def _assert_saves_close(a, b):
    for f in ("G", "D"):
        assert a[f].keys() == b[f].keys()
        for k, v in b[f].items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                np.testing.assert_allclose(a[f][k], v, rtol=1e-3, atol=1e-4, err_msg=f + k)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("one") / "o")
    _run(BASE + ["-o", out])
    return out


def test_mesh_shape_matches_one_process(tmp_path, one_process):
    out = str(tmp_path / "mesh")
    text = _run(BASE + ["--mesh_shape", "2", "-o", out])
    assert "torch.distributed: 2 rank(s) over gloo on the CPU." in text
    assert text.count("Finished training.") == 1            # rank 0 alone prints
    _assert_saves_close(_saves(out), _saves(one_process))
    with open(os.path.join(out, "privacy_log.csv")) as f1, \
            open(os.path.join(one_process, "privacy_log.csv")) as f2:
        assert f1.read() == f2.read()


def test_multihost_matches_one_process(tmp_path, one_process):
    out = str(tmp_path / "mh")
    store, procs = _multihost(BASE + ["-o", out])
    outs = _wait(procs)
    assert "over gloo on the CPU" in outs[0] and "Finished training." not in outs[1]
    _assert_saves_close(_saves(out), _saves(one_process))


def test_fsdp_saves_are_single_device_saves(tmp_path, one_process):
    out2, out1 = str(tmp_path / "two"), str(tmp_path / "one_plus_one")
    a = _start(BASE + ["--mesh_shape", "2", "--fsdp", "true", "-ne", "2", "-o", out2])
    b = _start(BASE + ["--mesh_shape", "2", "--fsdp", "true", "-o", out1])
    _wait([a, b])
    fsdp, ref = _saves(out1), _saves(one_process)
    for f in ("G", "D"):
        assert fsdp[f].keys() == ref[f].keys()
        for k, v in ref[f].items():
            if isinstance(v, np.ndarray):
                assert (fsdp[f][k].shape, fsdp[f][k].dtype) == (v.shape, v.dtype), f + k
    _assert_saves_close(fsdp, ref)
    _run(["MNIST", "-rp", out1, "-re", "1", "-ne", "2", "-ka", "n_epochs", "--platform", "cpu"])
    for f in ("G-2", "D-2"):
        with open(os.path.join(out1, "saves", f), "rb") as x, \
                open(os.path.join(out2, "saves", f), "rb") as y:
            assert x.read() == y.read(), f


def test_sigterm_to_one_rank_stops_both_after_the_same_epoch(tmp_path):
    out = str(tmp_path / "term")
    argv = BASE + ["-ne", "400", "--log_every", "96", "--save_every", "1000", "-o", out]
    store, procs = _multihost(argv)
    seen = threading.Event()
    lines = []

    def read():
        for raw in iter(procs[0].stdout.readline, b""):
            lines.append(raw.decode(errors="replace"))
            if lines[-1].startswith("=== Epoch 2 "):
                seen.set()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    if not seen.wait(90):
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        pytest.fail("rank 0 logged no epoch:\n" + "".join(lines[-20:]))
    procs[1].send_signal(signal.SIGTERM)
    _wait([procs[1]], 90)
    procs[0].wait(90)
    t.join(10)
    text = "".join(lines)
    assert procs[0].returncode == 0, text[-3000:]
    stopped = [ln for ln in lines if ln.startswith("Preempted after epoch ")]
    assert len(stopped) == 1, text[-3000:]
    epoch = int(stopped[0].split()[3].rstrip(";"))
    assert 2 <= epoch < 399
    saves = sorted(os.listdir(os.path.join(out, "saves")))
    assert saves == [f"D-{epoch + 1}", f"G-{epoch + 1}"]


def test_dryrun_two_ranks():
    r = subprocess.run([sys.executable, "-m", "csl_gan_tpu_torch.parallel.dryrun", "2"],
                       cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"ranks": 2, "batch": 16, "backend": "gloo"' in r.stdout
