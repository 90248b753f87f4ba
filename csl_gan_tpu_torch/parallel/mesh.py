"""The data axis of multi-device training on ``torch.distributed``: the
port's counterpart of the JAX package's parallel/mesh.py.

The JAX package trains over one ``Mesh`` with a ``data`` axis: the batch is
sharded, G and D are replicated, and XLA inserts the psums of the clipped
sums and the losses. Here each rank is one process on one device (a card,
or the CPU under ``--platform cpu``) and ``MeshContext`` says who it is:
world size, rank, device, backend and whether ``--fsdp`` shards the state.
Every rank draws the same global z, labels, permutation and noise from
generators seeded alike and keeps the rows ``shard_rows`` gives it
(``torch.tensor_split`` of the global batch, so any ``-bs`` works); the step
sums its local rows' gradients and all-reduces them.

Every collective is built from ``all_reduce`` and ``broadcast``, the two
that gloo offers for CUDA tensors, so one code path runs on NCCL (a card
per rank), on gloo over the CPU and on gloo over one shared card:

  - ``all_sum`` / ``all_sum_list`` / ``all_max``: in-place all-reduces (a
    list travels as one flat buffer);
  - ``gather_rows``: this rank's rows written into a zero buffer of the
    global size and summed (adding zeros is exact); differentiable, its
    backward the slice of the incoming gradient that belongs to this rank;
  - reduce-scatter (``--fsdp``'s gradient): ``all_reduce``, then the slice.

Two differentiable sums, for the two cases of what follows them:

  - ``sum_replicated`` (``_SumReplicated``): the value downstream is the
    same on every rank and every rank back-propagates the same loss through
    it, so the gradient of the local input is the incoming gradient itself
    (identity backward). The gathers of D's per-row outputs (the loss is
    then the single-device loss of the whole batch, on every rank) and the
    immediate-sensitivity step's reduced gradient use it.
  - ``sum_distinct`` (``_SumDistinct``): each rank back-propagates its own
    rows' share of the loss, so the gradient of the sum is the sum of the
    ranks' incoming gradients (all-reduce in the backward, what
    ``torch.distributed.nn.functional.all_reduce`` does). The BatchNorm G's
    batch statistics use it.

``--fsdp`` (ZeRO-3 over the same axis): each leaf of ``_FSDP_MIN_LEAF``
elements or more is split on its largest world-divisible dim
(``state_spec``, the JAX package's rule applied to the port's leaf shapes);
its Adam moments follow. Params are gathered whole for a step
(``unshard``), the reduced gradients sliced, and Adam updates the local
shard (``shard_leaf``); a save gathers the whole state first.

A MeshContext without a process group (``MeshContext()``) is one device:
every collective is then the identity and the single-device arithmetic is
unchanged, bit for bit. A process group of one rank (``--multihost
--num_processes 1``) runs the collectives, which then copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Leaves smaller than this stay replicated under --fsdp (the JAX package's
# floor): the clipping vector, biases and norm scales fall under it.
_FSDP_MIN_LEAF = 2 ** 11


def state_spec(shape, dp: int, tp: int, fsdp: bool) -> Tuple[Optional[str], ...]:
    """The partition of one state leaf (the JAX package's ``state_spec``, as
    a tuple of axis names or None per dim; ``()`` is replicated): ``--tp``
    takes the last dim when it divides, ``--fsdp`` the largest
    dp-divisible dim left (the later dim on a tie). Leaves under the size
    floor, or with no divisible dim, stay replicated."""
    size = 1
    for d in shape:
        size *= d
    if not shape or size < _FSDP_MIN_LEAF:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    if tp > 1 and shape[-1] % tp == 0:
        spec[-1] = "model"
    if fsdp and dp > 1:
        cands = [(d, ax) for ax, d in enumerate(shape) if d % dp == 0 and spec[ax] is None]
        if cands:
            spec[max(cands)[1]] = "data"
    return tuple(spec) if any(spec) else ()


def fsdp_spec(shape, n: int) -> Tuple[Optional[str], ...]:
    """ZeRO-3 alone (no tp): the largest n-divisible dim over ``data``."""
    return state_spec(shape, n, 1, True)


def split_bounds(n: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank's part of n rows, as ``torch.tensor_split`` cuts
    them: the first n % world parts take one row more."""
    q, r = divmod(n, world)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (1 if rank < r else 0)


class _SumReplicated(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the identity (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g


class _SumDistinct(torch.autograd.Function):
    """all_reduce(SUM) whose backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


@dataclass
class MeshContext:
    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # The torch.distributed backend ("nccl" or "gloo"), None without a
    # process group.
    backend: Optional[str] = None
    fsdp: bool = False

    @property
    def grouped(self) -> bool:
        """Whether collectives run (a process group exists)."""
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # ---------------- rows ----------------

    def bounds(self, n: int) -> Tuple[int, int]:
        return split_bounds(n, self.world, self.rank)

    def shard_rows(self, t):
        """This rank's rows of a global batch tensor (None stays None)."""
        if t is None or self.world == 1:
            return t
        lo, hi = self.bounds(t.shape[0])
        return t[lo:hi]

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] global batch from every rank's rows: this rank's rows
        in a zero buffer, summed over the ranks. Differentiable; the gradient
        of ``local`` is its rows of the incoming gradient."""
        if not self.grouped:
            return local
        lo, hi = self.bounds(n)
        if hi - lo != local.shape[0]:
            raise ValueError(f"rank {self.rank} holds {local.shape[0]} rows of {n}; "
                             f"expected {hi - lo}")
        # fp32 on the wire (gloo has no bf16 sum); exact for bf16 rows.
        buf = torch.nn.functional.pad(local.float(), (0, 0) * (local.dim() - 1) + (lo, n - hi))
        return _SumReplicated.apply(buf).to(local.dtype)

    def gather_cols(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """``gather_rows`` over dim 1 ([k, rows] per-leaf norms)."""
        if not self.grouped:
            return local
        return self.gather_rows(local.T, n).T

    # ---------------- reductions ----------------

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (a new tensor), not differentiable."""
        if not self.grouped:
            return t
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        if not self.grouped:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def all_sum_list(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over ranks of each tensor, in one all-reduce of one flat
        fp32 buffer (each tensor keeps its dtype)."""
        if not self.grouped:
            return list(ts)
        flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
        dist.all_reduce(flat)
        out, off = [], 0
        for t in ts:
            out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_sum_dict(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(zip(d, self.all_sum_list(list(d.values()))))

    def sum_replicated(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over ranks, identity backward."""
        return _SumReplicated.apply(t) if self.grouped else t

    def sum_distinct(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over ranks, all-reduced backward."""
        return _SumDistinct.apply(t) if self.grouped else t

    def sum_replicated_list(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``sum_replicated`` of several tensors as one flat buffer."""
        if not self.grouped:
            return list(ts)
        flat = self.sum_replicated(torch.cat([t.reshape(-1) for t in ts]))
        return [part.reshape(t.shape) for part, t in
                zip(torch.split(flat, [t.numel() for t in ts]), ts)]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if not self.grouped:
            return t
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src)
        return out

    def agree(self, flag: bool) -> bool:
        """Rank 0's value of a host decision, on every rank: a branch that
        launches collectives must be taken alike by all ranks."""
        if not self.grouped:
            return flag
        return bool(self.broadcast(torch.tensor([float(flag)], device=self.device)).item())

    def any(self, flag: bool) -> bool:
        """True on every rank when it is true on one."""
        if not self.grouped:
            return flag
        return bool(self.all_max(torch.tensor([float(flag)], device=self.device)).item())

    # ---------------- --fsdp ----------------

    def leaf_dim(self, shape) -> Optional[int]:
        """The dim of a full leaf that --fsdp shards, None when replicated."""
        if not self.fsdp or self.world == 1:
            return None
        spec = fsdp_spec(tuple(shape), self.world)
        return spec.index("data") if spec else None

    def shard_leaf(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full leaf (its own storage); a leaf that
        stays replicated, or is a shard already, comes back as it is."""
        d = self.leaf_dim(t.shape)
        if d is None:
            return t
        n = t.shape[d] // self.world
        return t.narrow(d, self.rank * n, n).clone()

    def shard_tree(self, tree: Dict[str, torch.Tensor], shapes) -> Dict[str, torch.Tensor]:
        """Every leaf whose full shape is ``shapes[k]`` and which is still
        whole, cut to this rank's shard."""
        return {k: self.shard_leaf(v) if tuple(v.shape) == tuple(shapes[k]) else v
                for k, v in tree.items()}

    def unshard(self, tree: Dict[str, torch.Tensor], shapes) -> Dict[str, torch.Tensor]:
        """The whole leaves of a tree of shards (``shapes``: the full shape of
        each), in one all-reduce: each rank writes its shards into a zero
        buffer of the full sizes."""
        sharded = [k for k, v in tree.items() if tuple(v.shape) != tuple(shapes[k])]
        if not sharded:
            return tree
        full = {}
        bufs = []
        for k in sharded:
            shape = tuple(shapes[k])
            d = self.leaf_dim(shape)
            n = shape[d] // self.world
            buf = torch.zeros(shape, dtype=tree[k].dtype, device=tree[k].device)
            buf.narrow(d, self.rank * n, n).copy_(tree[k])
            bufs.append(buf)
        for k, v in zip(sharded, self.all_sum_list(bufs)):
            full[k] = v
        return {k: full.get(k, v) for k, v in tree.items()}
