"""Where the ranks of a multi-rank run meet (``parallel/launch.py``): on a
store that is listening before any rank exists, so that no other socket
can take its port between the choice of the port and the ranks' start.

  - ``spawn`` (``--mesh_shape N``, ``parallel.dryrun``): a hook that runs
    after the parent has its rendezvous and before the first rank starts
    tries to take the rendezvous port from another socket. The take must
    fail with EADDRINUSE, and the 2 gloo ranks must meet and all-reduce
    (over the world and a ``new_group``) with exit code 0. A parent that
    only picked a free port, to be bound later by rank 0, loses the port
    to the hook and the run to EADDRINUSE.
  - a harness of ``--multihost`` processes (``tests/test_torch_multiprocess.py``
    ``_multihost``, ``chip_smoke.py`` ``RankSets``): it holds the store
    (``held_store``), the same take fails, and a pair started with
    torchrun's agent-store variables (``AGENT_STORE_ENV``) joins that store
    as clients, rank 0 included, at ``--coordinator_address``.

The ranks run in subprocesses (this file run as a script), each with its
own timeout and one torch thread.
"""

import errno
import json
import os
import socket
import subprocess
import sys
from argparse import Namespace
from types import SimpleNamespace

import torch
import torch.distributed as dist

from csl_gan_tpu_torch.parallel import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
TIMEOUT_S = 60


def _take(port, held):
    """Bind and listen on ``port`` from a socket of this process, as any
    other socket of the machine could: "taken" (the socket is kept in
    ``held``), or the errno name of the refusal."""
    s = socket.socket()
    try:
        s.bind(("localhost", port))
        s.listen()
    except OSError as e:
        s.close()
        return errno.errorcode[e.errno]
    held.append(s)
    return "taken"


def _sum_ranks(opt, mesh):
    """A spawned rank: the ranks' sum over the world, then over a new group."""
    torch.set_num_threads(1)
    t = torch.tensor([mesh.rank + 1.0])
    dist.all_reduce(t)
    dist.all_reduce(t, group=dist.new_group(list(range(mesh.world))))
    if t.item() != 2 * 3.0:
        raise RuntimeError(f"rank {mesh.rank}: the sums read {t.item()}, not 6")


def _spawn_with_hook() -> None:
    """``spawn`` 2 ranks with the take as a hook: it runs when spawn builds
    its first rank process (the rendezvous port is ``_rank_entry``'s third
    argument), after the parent has its rendezvous and before any rank
    starts. Prints the take's outcome as a JSON line; the exit code is the
    run's."""
    real, held, seen = launch.mp.get_context, [], {}

    class Hooked:
        def __init__(self, method):
            self.ctx = real(method)

        def Process(self, target, args):
            if not seen:
                seen["take"] = _take(args[2], held)
                print(json.dumps(seen), flush=True)
            return self.ctx.Process(target=target, args=args)

    launch.mp = SimpleNamespace(get_context=Hooked)
    launch.spawn(_sum_ranks, 2, Namespace(platform="cpu", fsdp=False, tp=1))


def _multihost_rank(address: str, rank: int) -> None:
    """One ``--multihost`` process of a pair: joins at ``address`` and sums."""
    torch.set_num_threads(1)
    mesh = launch.init_multihost(Namespace(
        platform="cpu", fsdp=False, tp=1, multihost=True, coordinator_address=address,
        num_processes=2, process_id=rank))
    try:
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t)
        if t.item() != 3.0:
            raise RuntimeError(f"rank {rank}: the sum reads {t.item()}, not 3")
    finally:
        dist.destroy_process_group()


def _finish(procs):
    """(exit code, output) of each process, each within TIMEOUT_S; a process
    that outlives it is killed and the test fails."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        raise AssertionError("a rank did not end within its timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_spawn_holds_the_rendezvous_port_before_any_rank_starts():
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "spawn"], cwd=REPO,
                         env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    [(rc, out)] = _finish([p])
    takes = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"take"')]
    assert takes == [{"take": "EADDRINUSE"}], out[-3000:]
    assert rc == 0, out[-3000:]
    assert "torch.distributed: 2 rank(s) over gloo on the CPU." in out


def test_a_multihost_pair_joins_the_store_its_harness_holds():
    store, held = launch.held_store(2), []
    assert _take(store.port, held) == "EADDRINUSE"
    env = dict(ENV, **launch.AGENT_STORE_ENV)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "rank",
                               f"localhost:{store.port}", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for rc, out in _finish(procs):
        assert rc == 0, out[-3000:]
    # Both ranks wrote their addresses into the harness's store.
    assert store.num_keys() >= 2


if __name__ == "__main__":
    if sys.argv[1] == "spawn":
        _spawn_with_hook()
    else:
        _multihost_rank(sys.argv[2], int(sys.argv[3]))
