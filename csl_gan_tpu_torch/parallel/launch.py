"""Starting the ranks of a multi-device run (the JAX package's train.py
``jax.distributed.initialize`` and ``make_mesh``'s device count).

- ``--mesh_shape N`` on one host: ``world_size`` clamps N to the visible
  devices (JAX ``make_mesh``: ``min(n, len(devices))``; the CPU counts its
  cores), and ``spawn`` starts that many processes, rank r on ``cuda:r`` or,
  under ``--platform cpu``, on the CPU. The ranks meet on a store that the
  parent holds (``held_store``): it listens before any rank exists, and
  every rank joins it as a client.
- ``--multihost``: this process is one rank of ``--num_processes``,
  ``--process_id``, meeting at ``tcp://<--coordinator_address>`` (torchrun's
  ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` when the flags are
  absent), where rank 0 hosts the store, as JAX's coordinator does. Under
  torchrun's agent store (``AGENT_STORE_ENV`` in the environment) the
  launcher hosts it there instead and rank 0 is a client like the others
  (``torch.distributed.rendezvous``); a harness that starts ``--multihost``
  processes holds one so (``held_store``).

The backend (``placement``): NCCL when each rank has a card of its own;
gloo when the ranks run on the CPU, or when more processes than cards share
a host. Only ``spawn`` (all its ranks on this host) and a ``--multihost``
process whose environment says how many processes share its host
(torchrun's ``LOCAL_WORLD_SIZE``, with ``LOCAL_RANK``) can share a card;
without them a ``--multihost`` process takes NCCL and the card ``rank %
cards`` (one process a card, hosts filled in rank order). Rank 0 prints the
backend it took; a failed init raises, no other backend is tried. A rank
that finds no card raises.

``--tp N`` (``tensor_axis``) lays the ranks out as (data, model) = (world /
N, N), N clamped to the world (JAX ``make_mesh``); an N that does not divide
the world raises ValueError. ``init_rank`` builds every data group and
every model group (each rank takes part in each ``new_group`` call) and
keeps ``--fsdp`` only where the data axis has more than one rank.
"""

from __future__ import annotations

import multiprocessing.connection
import os
import signal
import threading
from datetime import timedelta
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from csl_gan_tpu_torch.parallel.mesh import MeshContext

# How long a collective may wait for the other ranks before it raises.
COLLECTIVE_TIMEOUT_S = 900


def visible_devices(platform) -> int:
    if platform == "cpu":
        return os.cpu_count() or 1
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the GPU unless "
                           "--platform cpu is given")
    return torch.cuda.device_count()


def world_size(opt, say: bool = True) -> int:
    """The number of ranks of a run: ``--num_processes`` under
    ``--multihost``, else ``--mesh_shape`` clamped to the visible devices
    (printed when the clamp bites, unless ``say`` is false). The one count
    of ranks: ``spawn`` starts this many, and K1's option-level gate
    (``options._k1_path``) reads it. ``--tp`` must divide it
    (``tensor_axis``)."""
    if opt.multihost:
        n = int(_multihost_args(opt)[1])
    else:
        n = int(opt.mesh_shape or 1)
        have = visible_devices(opt.platform) if n > 1 else 1
        if n > have:
            if say:
                print(f"--mesh_shape {n}: only {have} devices are visible; training on {have}.")
            n = have
        n = max(n, 1)
    tensor_axis(opt, n)
    return n


def tensor_axis(opt, world: int) -> int:
    """The size of the model axis of ``world`` ranks: ``--tp`` clamped to the
    world; ValueError unless it divides the world (JAX ``make_mesh``)."""
    tp = max(1, min(int(getattr(opt, "tp", 1) or 1), world))
    if world % tp != 0:
        raise ValueError(f"--tp {tp} must divide the mesh size {world}")
    return tp


# torchrun's agent-store contract: a --multihost process started with these
# joins the store at --coordinator_address as a client, rank 0 included.
AGENT_STORE_ENV = {"TORCHELASTIC_USE_AGENT_STORE": "True", "TORCHELASTIC_RESTART_COUNT": "0"}


def held_store(world: int) -> dist.TCPStore:
    """A store for ``world`` ranks that this process hosts: it listens, on a
    port the system picks, from the moment it exists, so no other socket
    can take that port before the ranks join. Its ``port`` goes to the
    ranks; it serves them while the object lives, so hold it until every
    rank has ended."""
    return dist.TCPStore("localhost", 0, world_size=world, is_master=True,
                         wait_for_workers=False,
                         timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _multihost_args(opt):
    """(address, world, rank) of a --multihost process."""
    env = os.environ
    addr = opt.coordinator_address
    if addr is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = opt.num_processes if opt.num_processes is not None else env.get("WORLD_SIZE")
    rank = opt.process_id if opt.process_id is not None else env.get("RANK")
    missing = [f for f, v in (("--coordinator_address", addr), ("--num_processes", world),
                              ("--process_id", rank)) if v is None]
    if missing:
        raise ValueError("--multihost needs " + ", ".join(missing))
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"--process_id {rank} is outside [0, {world})")
    return addr, world, rank


def placement(platform, cards: int, local_rank: int,
              local_world: Optional[int]) -> Tuple[Optional[int], str]:
    """(card index or None for the CPU, backend) of a rank that is
    ``local_rank`` of ``local_world`` processes on a host with ``cards``
    cards. ``local_world`` None: nothing says another process shares the
    host, so the rank has a card of its own."""
    if platform == "cpu":
        return None, "gloo"
    shared = local_world is not None and local_world > cards
    return local_rank % cards, "gloo" if shared else "nccl"


def init_rank(opt, rank: int, world: int, meet: Union[str, dist.Store], local_rank: int,
              local_world: Optional[int]) -> MeshContext:
    """Join the process group as ``rank`` of ``world`` and return this
    rank's MeshContext, on the card and backend ``placement`` gives.
    ``meet``: the ``host:port`` of the group's store (``--multihost``), or a
    client of a store that the launcher already holds (``spawn``)."""
    cards = 0 if opt.platform == "cpu" else visible_devices(opt.platform)
    index, backend = placement(opt.platform, cards, local_rank, local_world)
    if index is None:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    tp = tensor_axis(opt, world)
    join = {"init_method": f"tcp://{meet}"} if isinstance(meet, str) else {"store": meet}
    dist.init_process_group(backend, world_size=world, rank=rank,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S), **join)
    data_group = model_group = None
    if tp > 1:
        dp = world // tp
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = g
    if rank == 0:
        where = "the CPU" if device.type == "cpu" else (
            f"{cards} card(s) shared by {local_world} processes of this host"
            if backend == "gloo" else "a card a rank")
        axes = f" as (data, model) = ({world // tp}, {tp})" if tp > 1 else ""
        print(f"torch.distributed: {world} rank(s){axes} over {backend} on {where}.",
              flush=True)
    return MeshContext(world=world, rank=rank, device=device, backend=backend,
                       fsdp=bool(opt.fsdp) and world // tp > 1, tp=tp,
                       data_group=data_group, model_group=model_group)


def local_layout(rank: int, env=None) -> Tuple[int, Optional[int]]:
    """(local rank, local world) of a ``--multihost`` process: torchrun's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (``LOCAL_RANK`` defaults to rank
    mod the local world), else (rank, None)."""
    env = os.environ if env is None else env
    if "LOCAL_WORLD_SIZE" not in env:
        return int(env.get("LOCAL_RANK", rank)), None
    local_world = int(env["LOCAL_WORLD_SIZE"])
    return int(env.get("LOCAL_RANK", rank % local_world)), local_world


def init_multihost(opt) -> MeshContext:
    addr, world, rank = _multihost_args(opt)
    return init_rank(opt, rank, world, addr, *local_layout(rank))


def _rank_entry(rank: int, world: int, port: int, opt, fn, args) -> None:
    store = dist.TCPStore("localhost", port, world, is_master=False,
                          timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = init_rank(opt, rank, world, store, rank, world)
    try:
        fn(opt, mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, opt, *args) -> None:
    """Run ``fn(opt, mesh, *args)`` in ``world`` new processes, one rank each,
    meeting on a store that this process holds until every rank has ended.
    SIGTERM to this process goes on to every rank. A rank that fails stops
    the others, and this raises."""
    ctx = mp.get_context("spawn")
    store = held_store(world)   # the object, not only its port: it serves while it lives
    procs = [ctx.Process(target=_rank_entry, args=(r, world, store.port, opt, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    main = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, forward) if main else None
    try:
        alive = {p.sentinel: p for p in procs}
        failed = None
        while alive:
            for s in multiprocessing.connection.wait(list(alive)):
                p = alive.pop(s)
                p.join()
                if p.exitcode != 0 and failed is None:
                    failed = p
                    for q in alive.values():
                        q.terminate()
        if failed is not None:
            raise RuntimeError(f"rank {procs.index(failed)} of {world} exited with code "
                               f"{failed.exitcode}")
    finally:
        if main:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
