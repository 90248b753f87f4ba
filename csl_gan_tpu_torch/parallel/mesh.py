"""The data and model axes of multi-device training on
``torch.distributed``: the port's counterpart of the JAX package's
parallel/mesh.py.

The JAX package trains over one ``Mesh`` with a ``data`` axis and, under
``--tp N``, a ``model`` axis: (data, model) = (world / N, N), the model ranks
of one data index adjacent (``rank = data_index * tp + model_index``, JAX
``make_mesh``'s reshape). The batch is sharded over ``data``; G and D are
replicated, or under ``--tp`` column-parallel over ``model``; XLA inserts
the collectives. Here each rank is one process on one device (a card, or
the CPU under ``--platform cpu``) and ``MeshContext`` says who it is: world
size, rank, device, backend, the tensor axis and whether ``--fsdp`` shards
the state. Every rank draws the same global z, labels, permutation and
noise from generators seeded alike and keeps the rows ``shard_rows`` gives
its data index (``torch.tensor_split`` of the global batch over the data
axis, so any ``-bs`` works; the model ranks of one data index hold the same
rows); the step sums its local rows' gradients and all-reduces them over
its data group.

Every collective is built from ``all_reduce`` and ``broadcast``, the two
that gloo offers for CUDA tensors, so one code path runs on NCCL (a card
per rank), on gloo over the CPU and on gloo over one shared card:

  - ``all_sum`` / ``all_sum_list``: in-place all-reduces over the data group
    (a list travels as one flat buffer); ``all_max``, ``broadcast``,
    ``agree`` and ``any`` over the world;
  - ``gather_rows``: this rank's rows written into a zero buffer of the
    global size and summed over the data group (adding zeros is exact);
    differentiable, its backward the slice of the incoming gradient that
    belongs to this rank;
  - reduce-scatter (``--fsdp``'s gradient): ``all_reduce``, then the slice.

Two differentiable sums over the data group, for the two cases of what
follows them:

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

The model axis (``--tp``) places its collectives by hand where GSPMD
propagates shardings in the JAX package. A sharded layer holds its output
channels' slice; its input enters through ``copy_model`` (identity forward,
model-group all-reduce backward), and a consumer that needs every channel
reads ``gather_model`` (a zero-padded buffer summed over the model group:
all-gather forward, this rank's slice backward); ``split_model`` is the
converse (this rank's slice forward, all-gather backward) and
``reduce_model`` sums partial values (all-reduce forward, identity
backward). The four are two autograd Functions, ``_ModelCopy`` and
``_ModelReduce``, each the other's backward by its ``.apply``, so a double
backward (WGAN-GP's penalty, ``torch.func.vjp``) sees every collective;
each has a ``vmap`` rule that runs one collective on the whole batched
tensor, so the per-sample gradients of ``torch.func.vmap(grad)`` go through
them too.

Which leaves shard, and on which torch dim (``leaf_layout``): the JAX rule
(``state_spec``) on the leaf's flax shape (``flax_shape``: a conv kernel
[kh, kw, cin, cout], a dense kernel [in, out]), mapped back to the torch
dims. ``model`` is then dim 0 of a torch weight [O, I, kh, kw] / [O, I] and
of an [O] bias; ``--fsdp`` (ZeRO-3) takes the largest dp-divisible dim of
the rest. A rank's state holds its block of each leaf (``cut``) and its Adam
moments follow. Params are gathered over the data axis for a step
(``unshard(..., data_only=True)``: the rank's model slice), the reduced
gradients cut to the data shard, and Adam updates the local block; a save
gathers whole leaves over both axes.

A MeshContext without a process group (``MeshContext()``) is one device:
every collective is then the identity and the single-device arithmetic is
unchanged, bit for bit. A process group of one rank (``--multihost
--num_processes 1``) runs the collectives, which then copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Leaves smaller than this stay replicated under --fsdp and --tp (the JAX
# package's floor): the clipping vector, biases and norm scales fall under it.
_FSDP_MIN_LEAF = 2 ** 11


def state_spec(shape, dp: int, tp: int, fsdp: bool) -> Tuple[Optional[str], ...]:
    """The partition of one state leaf of flax shape ``shape`` (the JAX
    package's ``state_spec``, as a tuple of axis names or None per dim;
    ``()`` is replicated): ``--tp`` takes the last dim when it divides,
    ``--fsdp`` the largest dp-divisible dim left (the later dim on a tie).
    Leaves under the size floor, or with no divisible dim, stay replicated."""
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


def _flax_axes(name: str, shape) -> Tuple[int, ...]:
    """For each flax dim of the leaf, the torch dim that holds it: a conv
    weight [O, I, kh, kw] is flax [kh, kw, I, O], a dense weight [O, I] is
    flax [I, O]; biases, norm scales and an embedding table keep their
    layout (convert.py)."""
    if len(shape) == 4:
        return (2, 3, 1, 0)
    if len(shape) == 2 and "Embed" not in name:
        return (1, 0)
    return tuple(range(len(shape)))


def flax_shape(name: str, shape) -> Tuple[int, ...]:
    """The flax shape of the torch leaf ``name`` of shape ``shape``."""
    return tuple(shape[d] for d in _flax_axes(name, shape))


def split_bounds(n: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank's part of n rows, as ``torch.tensor_split`` cuts
    them: the first n % world parts take one row more."""
    q, r = divmod(n, world)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (1 if rank < r else 0)


class _SumReplicated(torch.autograd.Function):
    """all_reduce(SUM) over ``group`` whose backward is the identity (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumDistinct(torch.autograd.Function):
    """all_reduce(SUM) over ``group`` whose backward all-reduces the
    incoming gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _model_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` as a new tensor of t's dtype, fp32 on
    the wire (gloo has no bf16 sum)."""
    out = t.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _ModelCopy(torch.autograd.Function):
    """Into a column-parallel layer: the identity forward, the sum over the
    model group backward (``_ModelReduce``, so a double backward sees it)."""

    @staticmethod
    def forward(t, group):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ModelReduce.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        return _ModelCopy.apply(t, group), in_dims[0]


class _ModelReduce(torch.autograd.Function):
    """The sum over the model group forward, the identity backward
    (``_ModelCopy``); under ``vmap`` one collective on the batched tensor."""

    @staticmethod
    def forward(t, group):
        return _model_all_reduce(t, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ModelCopy.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        if in_dims[0] is None:
            return _ModelReduce.apply(t, group), None
        return _ModelReduce.apply(t.movedim(in_dims[0], 0), group), 0


@dataclass
class MeshContext:
    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # The torch.distributed backend ("nccl" or "gloo"), None without a
    # process group.
    backend: Optional[str] = None
    fsdp: bool = False
    # The model axis: tp ranks of one data index, adjacent.
    tp: int = 1
    # This rank's data group (the ranks of its model index) and model group
    # (the ranks of its data index); None is the world (no tensor axis).
    data_group: Any = None
    model_group: Any = None

    @property
    def grouped(self) -> bool:
        """Whether collectives run (a process group exists)."""
        return self.backend is not None

    @property
    def dp(self) -> int:
        """The data axis's size."""
        return self.world // self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_collectives(self) -> bool:
        """Whether the data axis's collectives run: under a process group,
        unless the tensor axis takes every rank (a data group of one)."""
        return self.grouped and (self.tp == 1 or self.dp > 1)

    # ---------------- rows ----------------

    def bounds(self, n: int) -> Tuple[int, int]:
        return split_bounds(n, self.dp, self.data_index)

    def shard_rows(self, t):
        """This rank's rows of a global batch tensor (None stays None)."""
        if t is None or self.dp == 1:
            return t
        lo, hi = self.bounds(t.shape[0])
        return t[lo:hi]

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] global batch from every rank's rows: this rank's rows
        in a zero buffer, summed over the data group. Differentiable; the
        gradient of ``local`` is its rows of the incoming gradient."""
        if not self.data_collectives:
            return local
        lo, hi = self.bounds(n)
        if hi - lo != local.shape[0]:
            raise ValueError(f"rank {self.rank} holds {local.shape[0]} rows of {n}; "
                             f"expected {hi - lo}")
        # fp32 on the wire (gloo has no bf16 sum); exact for bf16 rows.
        buf = torch.nn.functional.pad(local.float(), (0, 0) * (local.dim() - 1) + (lo, n - hi))
        return _SumReplicated.apply(buf, self.data_group).to(local.dtype)

    def gather_cols(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """``gather_rows`` over dim 1 ([k, rows] per-leaf norms)."""
        if not self.data_collectives:
            return local
        return self.gather_rows(local.T, n).T

    # ---------------- reductions ----------------

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data group (a new tensor), not differentiable."""
        if not self.data_collectives:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, group=self.data_group)
        return out

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The max over every rank."""
        if not self.grouped:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def _sum_list(self, ts: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
        flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
        dist.all_reduce(flat, group=group)
        out, off = [], 0
        for t in ts:
            out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def all_sum_list(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data group of each tensor, in one all-reduce of
        one flat fp32 buffer (each tensor keeps its dtype)."""
        if not self.data_collectives:
            return list(ts)
        return self._sum_list(ts, self.data_group)

    def all_sum_dict(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(zip(d, self.all_sum_list(list(d.values()))))

    def sum_replicated(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the data group, identity backward."""
        return _SumReplicated.apply(t, self.data_group) if self.data_collectives else t

    def sum_distinct(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the data group, all-reduced backward."""
        return _SumDistinct.apply(t, self.data_group) if self.data_collectives else t

    def sum_replicated_list(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``sum_replicated`` of several tensors as one flat buffer."""
        if not self.data_collectives:
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

    # ---------------- the model axis (--tp) ----------------

    def model_bounds(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's slice of n channels (tp divides n)."""
        q = n // self.tp
        return self.model_index * q, (self.model_index + 1) * q

    def copy_model(self, t: torch.Tensor) -> torch.Tensor:
        """Identity forward, sum over the model group backward."""
        return _ModelCopy.apply(t, self.model_group) if self.tp > 1 else t

    def reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model group forward, identity backward."""
        return _ModelReduce.apply(t, self.model_group) if self.tp > 1 else t

    def split_model(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` (the same on the model group) on
        ``dim``; the backward gathers the slices' gradients."""
        if self.tp == 1:
            return t
        lo, hi = self.model_bounds(t.shape[dim])
        return self.copy_model(t).narrow(dim, lo, hi - lo)

    def gather_model(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice on ``dim``, in model order: this rank's slice in
        a zero buffer, summed over the model group; the backward is this
        rank's slice of the incoming gradient."""
        if self.tp == 1:
            return local
        dim = dim % local.dim()
        q = local.shape[dim]
        lo = self.model_index * q
        pad = (0, 0) * (local.dim() - 1 - dim) + (lo, (self.tp - 1) * q - lo)
        return self.reduce_model(torch.nn.functional.pad(local, pad))

    # ---------------- the state's layout (--tp, --fsdp) ----------------

    @property
    def shards_state(self) -> bool:
        """Whether a rank's state holds blocks of some leaves."""
        return self.tp > 1 or self.fsdp

    def leaf_layout(self, name: str, shape) -> Tuple[Optional[int], Optional[int]]:
        """(model dim, data dim) of the torch leaf ``name`` of full shape
        ``shape``: the JAX rule on its flax shape; None where the leaf is
        not cut on that axis."""
        if not self.shards_state:
            return None, None
        spec = state_spec(flax_shape(name, shape), self.dp, self.tp,
                          self.fsdp and self.dp > 1)
        if not spec:
            return None, None
        axes = _flax_axes(name, shape)
        return tuple(axes[spec.index(a)] if a in spec else None for a in ("model", "data"))

    def leaf_dim(self, shape, name: str = "") -> Optional[int]:
        """The dim of a full leaf that --fsdp shards, None when it does not."""
        return self.leaf_layout(name, tuple(shape))[1]

    def model_dim(self, name: str, shape) -> Optional[int]:
        """The dim of a full leaf that --tp cuts, None when replicated."""
        return self.leaf_layout(name, tuple(shape))[0]

    def cut(self, name: str, shape, t: torch.Tensor, model: bool = True,
            data: bool = True) -> torch.Tensor:
        """This rank's block of ``t``, a tensor of the leaf ``name`` of full
        shape ``shape`` (whole on the axes to cut): its model slice
        (``model``) and its data shard (``data``), as views."""
        md, dd = self.leaf_layout(name, tuple(shape))
        if model and md is not None:
            q = t.shape[md] // self.tp
            t = t.narrow(md, self.model_index * q, q)
        if data and dd is not None:
            q = t.shape[dd] // self.dp
            t = t.narrow(dd, self.data_index * q, q)
        return t

    def local_shape(self, name: str, shape, data: bool = True) -> Tuple[int, ...]:
        """The shape of this rank's block of a leaf (its model slice alone
        with ``data`` false)."""
        return tuple(self.cut(name, shape, torch.empty(tuple(shape), device="meta"),
                              data=data).shape)

    def shard_leaf(self, t: torch.Tensor, name: str = "") -> torch.Tensor:
        """This rank's block of a whole leaf (its own storage); a leaf that
        stays replicated comes back as it is."""
        md, dd = self.leaf_layout(name, tuple(t.shape))
        if md is None and dd is None:
            return t
        return self.cut(name, t.shape, t).clone()

    def shard_tree(self, tree: Dict[str, torch.Tensor], shapes) -> Dict[str, torch.Tensor]:
        """Every leaf of full shape ``shapes[k]`` that is still whole, or
        still this rank's whole model slice (a step's params), cut to this
        rank's block."""
        out = {}
        for k, v in tree.items():
            full = tuple(shapes[k])
            if tuple(v.shape) == full:
                v = self.shard_leaf(v, k)
            elif self.fsdp and tuple(v.shape) == self.local_shape(k, full, data=False) \
                    and self.leaf_layout(k, full)[1] is not None:
                v = self.cut(k, full, v, model=False).clone()
            out[k] = v
        return out

    def unshard(self, tree: Dict[Any, torch.Tensor], shapes, names=None,
                data_only: bool = False) -> Dict[Any, torch.Tensor]:
        """The leaves of a tree of blocks made whole (``shapes``: the full
        shape of each; ``names``: the leaf name of each key, the key itself
        by default), in one all-reduce: each rank writes its block into a
        zero buffer of the target size. With ``data_only`` the target is
        the rank's model slice (the blocks are summed over the data group),
        else the whole leaf (over the world, each block written by one
        rank)."""
        names = names if names is not None else {k: k for k in tree}
        todo, bufs = [], []
        for k, v in tree.items():
            name, shape = names[k], tuple(shapes[k])
            target = self.local_shape(name, shape, data=False) if data_only else shape
            if tuple(v.shape) == target:
                continue
            md, dd = self.leaf_layout(name, shape)
            buf = torch.zeros(target, dtype=v.dtype, device=v.device)
            writes = data_only or ((md is not None or self.model_index == 0)
                                   and (dd is not None or self.data_index == 0))
            if writes:
                self.cut(name, shape, buf, model=not data_only).copy_(v)
            todo.append(k)
            bufs.append(buf)
        if not todo:
            return tree
        whole = dict(zip(todo, self._sum_list(bufs, self.data_group if data_only else None)))
        return {k: whole.get(k, v) for k, v in tree.items()}
