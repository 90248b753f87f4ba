"""Rank workers of the port's multi-device tests
(tests/test_torch_{parallel,sharded_steps,multiprocess,tensor_axis}.py).
This module imports torch and the port only: every spawned rank imports it
again, and it must not pull JAX in.

    python tests/torch_parallel_cases.py <worker> <ranks> [--tp=N] <args...>

starts ``<ranks>`` CPU ranks over gloo (``parallel/launch.spawn``), laid out
as (data, model) = (ranks / N, N) with ``--tp=N``, each running
``<worker>(opt, mesh, *args)``; ``run_ranks`` does it from a test as a
subprocess with a timeout, so a rank that hangs in a collective fails the
test instead of the suite. Each rank uses one intra-op thread.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
from argparse import Namespace

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from csl_gan_tpu_torch import options as toptions  # noqa: E402
from csl_gan_tpu_torch.models.registry import init_models  # noqa: E402
from csl_gan_tpu_torch.parallel import launch  # noqa: E402
from csl_gan_tpu_torch.training.steps import StepBuilder  # noqa: E402


def run_ranks(worker: str, ranks: int, *args, timeout: float = 120.0, tp: int = 1):
    """Run ``worker`` on ``ranks`` CPU ranks (``tp`` of them a data index)
    in a subprocess; kill its whole process group and fail on a timeout.
    Returns the subprocess's output."""
    cmd = [sys.executable, os.path.abspath(__file__), worker, str(ranks), f"--tp={tp}",
           *map(str, args)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{worker} on {ranks} ranks timed out after {timeout} s")
    text = out.decode(errors="replace")
    assert p.returncode == 0, f"{worker} on {ranks} ranks failed:\n{text[-6000:]}"
    return text


# ---------------- collectives ----------------

def collectives(opt, mesh, out_dir: str) -> None:
    """The collectives on uneven rows: ``shard_rows`` / ``gather_rows`` of a
    [7, 3] batch, ``all_sum`` / ``all_max`` / ``broadcast`` / ``agree``, and
    the gradients of both differentiable sums of 2 * a (a this rank's
    tensor), back-propagated from a loss computed alike on every rank."""
    torch.set_num_threads(1)
    full = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    local = mesh.shard_rows(full)
    gathered = mesh.gather_rows(local * 1.0, 7)
    a = torch.tensor([1.0, 2.0, 3.0]) * (mesh.rank + 1)
    grads = {}
    for name in ("replicated", "distinct"):
        leaf = a.clone().requires_grad_(True)
        s = getattr(mesh, "sum_" + name)(2.0 * leaf)
        (s * s).sum().backward()
        grads[name] = leaf.grad
    # gather_rows's backward: the incoming gradient's rows of this rank.
    leaf = local.clone().requires_grad_(True)
    w = torch.arange(21, dtype=torch.float32).reshape(7, 3) + 1
    (mesh.gather_rows(leaf, 7) * w).sum().backward()
    torch.save({"local": local, "gathered": gathered, "grads": grads,
                "gather_grad": leaf.grad, "bounds": mesh.bounds(7),
                "sum": mesh.all_sum(a), "max": mesh.all_max(a),
                "bcast": mesh.broadcast(a), "agree": mesh.agree(mesh.rank == 0),
                "any": mesh.any(mesh.rank == mesh.world - 1),
                "list": mesh.all_sum_list([a, a[:2] * 2])},
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))


# ---------------- one D and G step per case ----------------

def steps(opt, mesh, payload: str, out_dir: str) -> None:
    """For each case of ``payload`` (a list of dicts: name, argv, fsdp,
    state, d: ``d_core`` keyword arguments, g: (z, y) or None): one D step
    and, with g, one G step on this rank's rows. Rank 0 saves the whole
    state after the steps and the metrics; every rank saves the shapes of
    the state it held. A case with ``noise_rows`` also saves, from every
    rank, the fused route's noise of its slices (``_fused_noise``)."""
    torch.set_num_threads(1)
    cases = torch.load(payload, weights_only=False)
    results = {}
    for case in cases:
        with tempfile.TemporaryDirectory() as tmp:
            topt = toptions.parse(case["argv"] + ["--platform", "cpu", "-o", tmp])
            G, D = init_models(topt, torch.device("cpu"))
        m = dataclasses.replace(mesh, fsdp=bool(case["fsdp"]) and mesh.dp > 1)
        tb = StepBuilder(topt, G, D, mesh=m)
        state = tb.shard_state(case["state"])
        noise = None
        if case.get("noise_rows"):
            noise = _fused_noise(tb, case["d"]["fused"], case["noise_rows"])
        held = {f: {k: tuple(v.shape) for k, v in getattr(state, f).items()}
                for f in ("d_params", "d_mu", "g_params", "g_mu")}
        d = dict(case["d"])
        fake_gap = None
        if "fake" in d:
            # The given fakes' rows, against this rank's own G forward.
            d["fake"] = mesh.shard_rows(d["fake"])
            own = tb.fakes(tb.full_params(state).g_params, *tb._rows(d["z"], d["y"]))
            fake_gap = float((own - d["fake"]).abs().max())
        state, dm = tb.d_core(state, **d)
        gm = None
        if case["g"] is not None:
            state, gm = tb.g_core(state, *case["g"])
        held_after = {k: tuple(v.shape) for k, v in state.d_mu.items()}
        whole = tb.full_state(state)
        results[case["name"]] = {"state": whole if mesh.is_main else None, "d": dm, "g": gm,
                                 "held": held, "held_after": held_after,
                                 "fake_gap": fake_gap, "noise": noise}
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def _fused_noise(tb, fused, rows: int):
    """The fused route's noise of this rank's slices alone: the weighted sum
    (K6's plain version at the slices' counter bases, the small leaves'
    normals cut) of zero per-sample gradients of ``rows`` rows, by leaf."""
    from csl_gan_tpu_torch.ops import grads as gops
    local = tb._local_fused(fused)
    shapes = {k: tb.mesh.local_shape(k, tb.d_shapes[k], data=False) for k in tb.d_leaves}
    zeros = {k: torch.zeros((rows,) + shapes[k]) for k in tb.d_leaves}
    return gops.weighted_sum_fused_noise(zeros, torch.zeros(len(tb.d_leaves), rows), local)


if __name__ == "__main__":
    worker, ranks, tp, *rest = sys.argv[1:]
    launch.spawn(globals()[worker], int(ranks),
                 Namespace(platform="cpu", fsdp=False, tp=int(tp[len("--tp="):])), *rest)
