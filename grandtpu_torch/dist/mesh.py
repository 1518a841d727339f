"""The port's device mesh (port of ``grandtpu/dist/mesh.py``).

A :class:`Mesh` is a (data, model) grid of S = n_data x n_model shards,
shard ``g = d * n_model + m`` at data row d and model column m (the order
of grandtpu's ``devices.reshape(n_data, n_model)``); a 1-D mesh is the
case ``n_model == 1``. grandtpu's mesh spans every
device of every process once the user has called
``jax.distributed.initialize``; the port's spans the ranks of
``torch.distributed`` once the user has called ``init_process_group`` (or
started the job with ``torchrun``), and one process otherwise:

- one process (``ranks == 1``): ``devices`` lists every shard's device in
  shard order; a device may stand there more than once (several shards
  then share one card, or the CPU, as ``chip_smoke.py`` runs four shards
  on one card and the tests run them on the CPU). The collectives are
  ``Tensor.to`` copies and sums, and autograd differentiates them;
- ``ranks`` processes: rank r holds the shards ``shards`` (S / ranks of
  them, in global order, ``devices`` their device, one device a rank).
  Every per-shard list that a collective takes or returns holds this
  process's shards only, and every method keeps its meaning on the whole
  mesh. Each cross-process collective is an explicit
  ``torch.autograd.Function`` whose backward is the adjoint for values
  replicated on every rank, as ``shard_map``'s ``psum`` and
  ``pbroadcast`` are: every rank backpropagates the same replicated loss.

The collectives the data-parallel step uses are differentiable:

========================  ============================  ===================
method                    forward                       backward
========================  ============================  ===================
``broadcast(x)``          x on the local shards         sum the local
                                                        gradients, then
                                                        over the ranks
``reduce_sum(xs)``        sum over every shard, the     the gradient to each
                          same value on every rank      local shard as it is
``all_reduce_sum(xs)``    that sum on each local shard  an all-reduce
``all_gather(xs)``        every block on each shard     a reduce-scatter
``scatter_rows(x)``       this rank's blocks of x       a gather
``reduce_scatter_rows``   the sum's local blocks        an all-gather
========================  ============================  ===================

``all_to_all``, ``pmax`` and ``gather_rows`` are forward only;
``gather_rows`` returns the whole result on every rank, as grandtpu's
``fetch_replicated`` does. Every sum adds the shards' terms in global
shard order on every rank (an all-gather, then a local sum), so every rank
holds the same bits and the replicas (parameters, BatchNorm state, Adam
moments) cannot drift apart.

On a 2-D mesh each of these acts on the data axis, within each model
column, as on the 1-D mesh of that column (:meth:`Mesh.column`). What
grandtpu shards along one axis and replicates over the other (D1, the
source-sharded push) runs once on each 1-D mesh that :meth:`Mesh.along`
gives: along 'data' the model columns, along 'model' the data rows
(:meth:`Mesh.row`), each with its shards named by their index along the
axis. A value
that the model columns hold alike (replicated over 'model') is
backpropagated by every column, as Megatron's tensor-parallel ranks each
backpropagate the same loss: so ``broadcast`` and ``scatter_rows`` take
their gradient from one model column (the first this process holds),
summed over the data axis, and ``reduce_sum`` and ``gather_rows`` return
that column's result, ``reduce_sum`` handing its gradient to every
column's terms. The model axis has its own operations, each with its
adjoint written out (Megatron's pair and the column blocks):

========================  ============================  ===================
method                    forward                       backward
========================  ============================  ===================
``model_all_reduce`` (g)  the sum over a data row's     the identity (what
                          model shards, in model order  follows is
                                                        replicated)
``model_copy`` (f)        the identity                  that sum
``model_split``           block m of a replicated       a model all-gather
                          value on model shard m
``model_all_gather``      the row's blocks joined       the shard's block
``broadcast_columns``     model shard m's parameter on  summed over the
                          column m's shards             data axis
``broadcast_rows``        data row d's parameter on     the first local
                          row d's shards                column's gradient
========================  ============================  ===================

Over processes a rank holds contiguous shards: whole data rows ('model'
inside the rank) or a part of one row ('model' across ranks). The
``torch.distributed`` groups of the data rows and model columns that span
ranks are made once, by :func:`make_mesh`, in the same order on every
rank.

The transport follows the process group's backend, with no fall-back
from one to the other: ``nccl`` takes card tensors as they are (a CPU
tensor goes through the rank's card), ``gloo`` stages card tensors
through pinned host memory. NCCL refuses two ranks on one card, so
:func:`make_mesh` raises on such a job and names gloo, which runs it.
:data:`TRANSPORT` counts the collectives and their seconds.
"""

from __future__ import annotations

import dataclasses
import functools
import socket
import time

import torch
import torch.distributed as tdist

from grandtpu_torch.device import resolve_device

# the cross-process collectives of this process: calls, bytes sent, and
# the seconds of gloo's staging copies and of the collectives themselves
TRANSPORT = {"calls": 0, "bytes": 0, "stage_s": 0.0, "comm_s": 0.0}


def reset_transport() -> None:
    TRANSPORT.update(calls=0, bytes=0, stage_s=0.0, comm_s=0.0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards of a (data, model) grid: ``devices[i]`` holds shard
    ``shards[i]`` (default: every shard, 0..len(devices)-1, in one
    process), shard g at data row ``g // n_model`` and model column
    ``g % n_model``. On a mesh over ``ranks`` processes this process, rank
    ``rank``, holds the shards ``shards``; ``group`` names the ranks its
    collectives span (None: every rank)."""
    devices: tuple[torch.device, ...]
    shards: tuple[int, ...] | None = None
    ranks: int = 1
    rank: int = 0
    n_model: int = 1
    group: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.shards is None:
            object.__setattr__(self, "shards",
                               tuple(range(len(self.devices))))
        if self.size % self.n_model:
            raise ValueError(f"{self.size} shards do not make rows of "
                             f"{self.n_model} model shards")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        """The global shard count."""
        return len(self.shards) * self.ranks

    @property
    def n_data(self) -> int:
        return self.size // self.n_model

    @property
    def data_shards(self) -> tuple[int, ...]:
        """The data row of each of this process's shards."""
        return tuple(g // self.n_model for g in self.shards)

    @property
    def model_shards(self) -> tuple[int, ...]:
        """The model column of each of this process's shards."""
        return tuple(g % self.n_model for g in self.shards)

    @property
    def local_columns(self) -> tuple[int, ...]:
        """The model columns this process holds shards of, in order."""
        return tuple(dict.fromkeys(self.model_shards))

    @property
    def multiprocess(self) -> bool:
        return self.ranks > 1

    def column(self, c: int) -> "Mesh":
        """The 1-D mesh of model column ``c``'s data shards that this
        process holds (the mesh itself when ``n_model == 1``)."""
        return _columns(self)[c][1]

    def row(self, d: int) -> "Mesh":
        """The 1-D mesh of data row ``d``'s model shards that this process
        holds, its shards named by model column; over the row's ranks when
        'model' spans ranks (:attr:`model_group`)."""
        return _rows(self)[d][1]

    def along(self, axis: str) -> dict:
        """{group: (its local shard indices, its 1-D mesh)} for each group
        of shards along ``axis`` that this process holds, in ascending
        order: along 'data' the model columns (:meth:`column`), along
        'model' the data rows (:meth:`row`). Work that grandtpu shards
        along ``axis`` and replicates over the other axis runs once on each
        group's mesh; on a 1-D mesh along 'data' the one group's mesh is
        the mesh itself."""
        if axis == "data":
            return _columns(self)
        if axis == "model":
            return _rows(self)
        raise ValueError(f"the mesh's axes are 'data' and 'model', not "
                         f"{axis!r}")

    def per_device(self, make):
        """``make(device)`` once for each distinct local device, in shard
        order (shards on one device share the result)."""
        made = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def _by_column(self, args: dict, op) -> list:
        """``op(column c's 1-D mesh, args[c])`` for each local model column
        c, the per-shard results back in shard order."""
        out = [None] * len(self.shards)
        for c, (idx, sub) in _columns(self).items():
            for i, y in zip(idx, op(sub, args[c])):
                out[i] = y
        return out

    def _per_column(self, xs: list, op) -> list:
        """``op(column mesh, the column's tensors)`` for each local model
        column."""
        return self._by_column({c: [xs[i] for i in idx] for c, (idx, _)
                                in _columns(self).items()}, op)

    def _replicated(self, x: torch.Tensor, op) -> list:
        """``op(column mesh, x)`` for each local model column, the columns
        holding ``x`` alike: its gradient is taken from the first local
        column only (the others see it detached)."""
        first = self.model_shards[0]
        return self._by_column({c: x if c == first else x.detach()
                                for c in self.local_columns}, op)

    def all_gather(self, xs: list[torch.Tensor],
                   dim: int = 0) -> list[torch.Tensor]:
        """Each shard's block, concatenated in shard order along ``dim`` on
        every shard's device ([S * r, ...] for dim 0); shards on one device
        share the copy, which they must only read. Differentiable: the
        backward sums each copy's gradient slices back onto their shards
        (a reduce-scatter)."""
        if self.n_model > 1:
            return self._per_column(xs, lambda m, ys: m.all_gather(ys, dim))
        if self.multiprocess:
            out = _apply(_AllGather, xs, self, dim)
            return self.per_device(lambda d: out.to(d))
        return self.per_device(
            lambda d: torch.cat([x.to(d) for x in xs], dim))

    def broadcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` (on any device; on a process mesh the same on every rank)
        on every local shard's device; shards on one device share it. The
        backward sums the shards' gradients (a reduce onto ``x``'s device,
        then over the ranks); on a 2-D mesh those of the first local model
        column."""
        if self.n_model > 1:
            return self._replicated(x, lambda m, y: m.broadcast(y))
        if self.multiprocess and _needs_grad(x):
            x = _SumGrads.apply(x, self.group)
        return self.per_device(lambda d: x.to(d))

    def broadcast_columns(self, ps: list[torch.Tensor]) -> list:
        """``ps[j]``, the block of model column ``local_columns[j]`` (a
        model-sharded parameter), on each local shard of that column; the
        backward sums the column's gradients over the data axis."""
        return self._by_column(dict(zip(self.local_columns, ps)),
                               lambda m, p: m.broadcast(p))

    def broadcast_rows(self, ps: list[torch.Tensor]) -> list:
        """``ps[j]``, the block of this process's j-th data row (a parameter
        split over 'data', replicated over 'model'), on each local shard of
        that row. Its gradient is taken from the first local model column,
        as :meth:`broadcast`'s: the row's other model shards compute
        alike."""
        blocks = dict(zip(dict.fromkeys(self.data_shards), ps))
        first = self.model_shards[0]
        return [(blocks[d] if m == first else blocks[d].detach()).to(dev)
                for d, m, dev in zip(self.data_shards, self.model_shards,
                                     self.devices)]

    def gather_row_blocks(self, ps: list[torch.Tensor]) -> torch.Tensor:
        """Forward only: a parameter split over 'data' whole on the first
        local device, its blocks ``ps`` (one for each local data row, as
        :meth:`broadcast_rows` takes them) joined by rows; over processes
        a collective of the first local column's ranks."""
        return self.column(self.model_shards[0]).gather_rows(
            [p.detach() for p in ps])

    def row_blocks(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The inverse of :meth:`gather_row_blocks`: ``x`` (whole, with or
        without its zero padding rows) padded with zero rows to a multiple
        of the data rows and cut into n_data equal row blocks, those of
        this process's data rows in order (views of ``x``'s device)."""
        per = -(-x.shape[0] // self.n_data)
        pad = x.new_zeros(per * self.n_data - x.shape[0], *x.shape[1:])
        parts = torch.cat([x, pad]).split(per)
        return [parts[d] for d in dict.fromkeys(self.data_shards)]

    def reduce_sum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's tensor on the first local device, added
        in shard order (the same bits on every rank). The backward hands
        the gradient to each shard. On a 2-D mesh the sum over the data
        axis of the first local column's tensors (the columns hold alike
        values), whose gradient goes to every column's."""
        if self.n_model > 1:
            idx, sub = _columns(self)[self.model_shards[0]]
            total = sub.reduce_sum([xs[i] for i in idx])
            return _Collapse.apply(total, *(x for i, x in enumerate(xs)
                                            if i not in idx))
        if self.multiprocess:
            return _apply(_ReduceSum, xs, self)
        root = self.devices[0]
        out = xs[0].to(root)
        for x in xs[1:]:
            out = out + x.to(root)
        return out

    def all_reduce_sum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of every shard's tensor, on every shard's device (the
        same sum in shard order everywhere). Its backward is again an
        all-reduce."""
        if self.n_model > 1:
            return self._per_column(xs, lambda m, ys: m.all_reduce_sum(ys))
        return self.broadcast(self.reduce_sum(xs))

    def scatter_rows(self, x: torch.Tensor,
                     dim: int = 0) -> list[torch.Tensor]:
        """``x``'s n_data equal blocks along ``dim``, block d on the devices
        of data row d's shards, contiguous (the kernels take them as they
        are); on a process mesh ``x`` is the same on every rank and each
        rank gets its own blocks. The backward gathers the blocks'
        gradients."""
        n = x.shape[dim]
        if n % self.n_data:
            raise ValueError(f"{n} rows do not split over {self.n_data} "
                             "shards")
        if self.n_model > 1:
            return self._replicated(x, lambda m, y: m.scatter_rows(y, dim))
        if self.multiprocess:
            if _needs_grad(x):
                return list(_ScatterRows.apply(x, self, dim))
            blocks = x.split(n // self.size, dim)
            return [blocks[s].to(d).contiguous()
                    for s, d in zip(self.shards, self.devices)]
        return [b.to(d).contiguous()
                for b, d in zip(x.split(n // self.size, dim), self.devices)]

    def reduce_scatter_rows(self, xs: list[torch.Tensor],
                            dim: int = 0) -> list[torch.Tensor]:
        """The sum of every shard's [S * r, ...] tensor, block s of its rows
        (along ``dim``) on shard s's device. The backward all-gathers the
        blocks' gradients."""
        if self.n_model > 1:
            return self._per_column(
                xs, lambda m, ys: m.reduce_scatter_rows(ys, dim))
        return self.scatter_rows(self.reduce_sum(xs), dim)

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[s]`` [S, C, ...] holds what shard s sends to each shard;
        shard d receives ``stack_s(sends[s][d])`` [S, C, ...] on its
        device (grandtpu's ``lax.all_to_all`` with split and concat axis
        0, untiled)."""
        if self.n_model > 1:
            return self._per_column(sends, lambda m, ys: m.all_to_all(ys))
        if self.multiprocess:
            return _all_to_all(self, sends)
        return [torch.stack([send[d].to(dev) for send in sends])
                for d, dev in enumerate(self.devices)]

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise max of every shard's tensor, on every shard's
        device."""
        if self.n_model > 1:
            return self._per_column(xs, lambda m, ys: m.pmax(ys))
        if self.multiprocess:
            xs = _global_terms(self, xs)

        def make(d):
            out = xs[0].to(d, copy=True)
            for x in xs[1:]:
                torch.maximum(out, x.to(d), out=out)
            return out

        return self.per_device(make)

    def gather_rows(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The shards' row blocks concatenated on the first local device
        (on a process mesh the whole result on every rank; on a 2-D mesh
        the first local column's)."""
        if self.n_model > 1:
            idx, sub = _columns(self)[self.model_shards[0]]
            return sub.gather_rows([xs[i] for i in idx])
        if self.multiprocess:
            xs = _global_terms(self, xs)
        return torch.cat([x.to(self.devices[0]) for x in xs])

    # ------------------------------------------------- the model axis

    @property
    def model_group(self) -> tuple[int, ...] | None:
        """The ranks that hold this process's data row, when 'model' spans
        ranks (None when every row lies inside a rank)."""
        return _layout(self)[1]

    def model_all_reduce(self, xs: list[torch.Tensor]) -> list:
        """(g) the sum over each data row's model shards, in model order, on
        each of the row's shards; the backward is the identity, since what
        follows is replicated over 'model'."""
        return list(_apply(_ModelSum, xs, self))

    def model_copy(self, xs: list[torch.Tensor]) -> list:
        """(f) the identity on a value replicated over 'model' whose
        shards each use a part; the backward sums the row's gradients."""
        return list(_apply(_ModelCopy, xs, self))

    def model_split(self, xs: list[torch.Tensor], dim: int = -1) -> list:
        """Block m (of n_model equal blocks along ``dim``) of each model
        shard m's replicated value, contiguous; the backward joins the
        row's block gradients (a model all-gather)."""
        return list(_apply(_ModelSplit, xs, self, dim))

    def model_all_gather(self, xs: list[torch.Tensor], dim: int = -1
                         ) -> list:
        """The row's model blocks joined along ``dim`` on each of its
        shards; the backward hands each shard its block of the gradient."""
        return list(_apply(_ModelGather, xs, self, dim))

    def gather_columns(self, ps: list[torch.Tensor], dim: int
                       ) -> torch.Tensor:
        """Forward only: a model-sharded parameter whole on the first local
        device, its blocks ``ps`` (one for each local column, as
        :meth:`broadcast_columns` takes them) joined along ``dim``; when
        'model' spans ranks a collective of the row's ranks."""
        root = self.devices[0]
        ps = [p.detach().to(root) for p in ps]
        if self.model_group is not None:
            ps = [t for part in all_gather_tensor(torch.stack(ps),
                                                  self.model_group)
                  for t in part.unbind()]
        return torch.cat(ps, dim)

    def column_blocks(self, x: torch.Tensor, dim: int) -> list:
        """The inverse of :meth:`gather_columns`: ``x``'s n_model equal
        blocks along ``dim``, those of this process's model columns in
        order (views on ``x``'s device)."""
        parts = x.chunk(self.n_model, dim)
        return [parts[c] for c in self.local_columns]


@functools.lru_cache(maxsize=64)
def _layout(mesh: Mesh) -> tuple:
    """(the ranks that hold this process's model columns, over the data
    rows, or None for every rank; the ranks that hold its data row, or
    None when the row lies inside the rank)."""
    per, n_model = len(mesh.shards), mesh.n_model
    if not mesh.multiprocess or per % n_model == 0:
        return mesh.group, None
    q = n_model // per                    # ranks a data row spans
    j, d = mesh.rank % q, mesh.rank // q
    return (tuple(j + i * q for i in range(mesh.n_data)),
            tuple(range(d * q, (d + 1) * q)))


@functools.lru_cache(maxsize=64)
def _columns(mesh: Mesh) -> dict:
    """{model column: (its local shard indices, the 1-D mesh of its data
    shards)} for each local column, in order."""
    if mesh.n_model == 1:
        return {0: (tuple(range(len(mesh.shards))), mesh)}
    data_group = _layout(mesh)[0]
    out = {}
    for c in mesh.local_columns:
        idx = tuple(i for i, m in enumerate(mesh.model_shards) if m == c)
        rows = tuple(mesh.data_shards[i] for i in idx)
        if not mesh.multiprocess:
            sub = Mesh(tuple(mesh.devices[i] for i in idx), rows)
        elif data_group is None:            # every rank holds every column
            sub = Mesh(tuple(mesh.devices[i] for i in idx), rows,
                       mesh.ranks, mesh.rank)
        else:                               # one row a rank, its blocks
            sub = Mesh(tuple(mesh.devices[i] for i in idx), rows,
                       len(data_group), data_group.index(mesh.rank),
                       group=data_group)
        out[c] = (idx, sub)
    return out


@functools.lru_cache(maxsize=64)
def _rows(mesh: Mesh) -> dict:
    """{data row: (its local shard indices, the 1-D mesh of its model
    shards)} for each local row, in order."""
    group = _layout(mesh)[1]
    out = {}
    for d in dict.fromkeys(mesh.data_shards):
        idx = tuple(i for i, r in enumerate(mesh.data_shards) if r == d)
        devices = tuple(mesh.devices[i] for i in idx)
        cols = tuple(mesh.model_shards[i] for i in idx)
        if group is None:                   # the row lies inside the rank
            sub = Mesh(devices, cols)
        else:                               # the row spans the ranks group
            sub = Mesh(devices, cols, len(group), group.index(mesh.rank),
                       group=group)
        out[d] = (idx, sub)
    return out


def _model_rows(mesh: Mesh, xs) -> dict:
    """{data row: its n_model tensors in model order} for this process's
    data rows (gathered from the row's ranks when 'model' spans them)."""
    rows = {}
    for d, x in zip(mesh.data_shards, xs):
        rows.setdefault(d, []).append(x)
    group = mesh.model_group
    if group is not None:
        (d, local), = rows.items()
        stacked = torch.stack([x.to(mesh.devices[0]) for x in local])
        rows[d] = [t for part in all_gather_tensor(stacked, group)
                   for t in part.unbind()]
    return rows


def _block(x: torch.Tensor, m: int, n: int, dim: int) -> torch.Tensor:
    width = x.shape[dim]
    if width % n:
        raise ValueError(f"a width of {width} does not split over {n} model "
                         "shards")
    return x.narrow(dim, m * (width // n), width // n)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        rows = _model_rows(mesh, [x.detach() for x in xs])
        return tuple(_sum_in_order([t.to(x.device) for t in rows[d]])
                     for d, x in zip(mesh.data_shards, xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        rows = _model_rows(mesh, [g.contiguous() for g in gs])
        return (None, *(_sum_in_order([t.to(g.device) for t in rows[d]])
                        for d, g in zip(mesh.data_shards, gs)))


class _ModelSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        return tuple(_block(x, m, mesh.n_model, dim).contiguous()
                     for m, x in zip(mesh.model_shards, xs))

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        rows = _model_rows(mesh, [g.contiguous() for g in gs])
        return (None, None, *(torch.cat([t.to(g.device) for t in rows[d]],
                                        ctx.dim)
                              for d, g in zip(mesh.data_shards, gs)))


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        rows = _model_rows(mesh, [x.detach() for x in xs])
        return tuple(torch.cat([t.to(x.device) for t in rows[d]], dim)
                     for d, x in zip(mesh.data_shards, xs))

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        return (None, None, *(_block(g, m, mesh.n_model, ctx.dim).contiguous()
                              for m, g in zip(mesh.model_shards, gs)))


class _Collapse(torch.autograd.Function):
    """``total`` (one model column's sum); the backward hands its gradient
    to ``total`` and, as it is, to every other column's term."""

    @staticmethod
    def forward(ctx, total, *others):
        ctx.devices = [o.device for o in others]
        return total.view_as(total)

    @staticmethod
    def backward(ctx, g):
        return (g, *(g.to(d) for d in ctx.devices))


# ------------------------------------------------- the cross-process part


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _apply(fn, xs, mesh, *args):
    if len(xs) != len(mesh.shards):
        raise ValueError(f"{len(xs)} tensors for the {len(mesh.shards)} "
                         f"shards of rank {mesh.rank}")
    return fn.apply(mesh, *args, *xs)


def _staged(t: torch.Tensor, backend: str):
    """(the tensor the collective takes, the device to return to)."""
    if backend == "gloo" and t.device.type == "cuda":
        t0 = time.perf_counter()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        TRANSPORT["stage_s"] += time.perf_counter() - t0
        return h
    if backend == "nccl" and t.device.type == "cpu":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _backend() -> str:
    backend = tdist.get_backend()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"the mesh's transport takes the gloo or nccl "
                         f"backend, not {backend!r}")
    return backend


def _buffers(like: torch.Tensor, n: int) -> list[torch.Tensor]:
    pinned = like.device.type == "cpu" and like.is_pinned()
    return [torch.empty(like.shape, dtype=like.dtype, device=like.device,
                        pin_memory=pinned) for _ in range(n)]


def _returned(outs: list[torch.Tensor], device: torch.device) -> list:
    t0 = time.perf_counter()
    back = [o.to(device) for o in outs]
    if any(o.device != device for o in outs):
        TRANSPORT["stage_s"] += time.perf_counter() - t0
    return back


# the process groups make_mesh made: {(the world group, ranks): group}
_GROUPS: dict = {}


def _process_group(ranks: tuple[int, ...] | None):
    """The group of ``ranks`` (None, or every rank: the world), which
    :func:`make_mesh` made."""
    if ranks is None or len(ranks) == tdist.get_world_size():
        return None
    try:
        return _GROUPS[(tdist.group.WORLD, ranks)]
    except KeyError:
        raise RuntimeError(f"no process group of the ranks {ranks}: "
                           f"make_mesh makes a mesh's groups") from None


def _make_groups(groups: list) -> None:
    """Make the groups ``groups`` (tuples of ranks) not made yet; every
    rank calls this with the same list."""
    for ranks in groups:
        key = (tdist.group.WORLD, ranks)
        if 1 < len(ranks) < tdist.get_world_size() and key not in _GROUPS:
            _GROUPS[key] = tdist.new_group(list(ranks))


def all_gather_tensor(t: torch.Tensor,
                      ranks: tuple[int, ...] | None = None) -> list:
    """Every rank's ``t`` (the same shape on every rank), in rank order, on
    ``t``'s device; of the ranks ``ranks`` (default every rank), which
    this rank is one of."""
    backend = _backend()
    src = _staged(t.contiguous(), backend)
    outs = _buffers(src, tdist.get_world_size() if ranks is None
                    else len(ranks))
    t0 = time.perf_counter()
    tdist.all_gather(outs, src, group=_process_group(ranks))
    TRANSPORT["comm_s"] += time.perf_counter() - t0
    TRANSPORT["calls"] += 1
    TRANSPORT["bytes"] += t.numel() * t.element_size()
    return _returned(outs, t.device)


def _global_terms(mesh: Mesh, xs: list[torch.Tensor]) -> list:
    """Every shard's tensor in global shard order, on the first local
    device (the local ones stacked, then gathered over the ranks)."""
    root = mesh.devices[0]
    stacked = torch.stack([x.detach().to(root) for x in xs])
    return [t for part in all_gather_tensor(stacked, mesh.group)
            for t in part.unbind()]


def _sum_in_order(terms: list[torch.Tensor]) -> torch.Tensor:
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _all_reduce(t: torch.Tensor, ranks=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (of ``ranks``), added in rank
    order."""
    return _sum_in_order(all_gather_tensor(t, ranks))


class _SumGrads(torch.autograd.Function):
    """The identity on a replicated value; the backward sums the ranks'
    gradients (broadcast's adjoint across processes)."""

    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.ranks), None


class _ReduceSum(torch.autograd.Function):
    """The sum of every shard's term in global order, the same on every
    rank; the backward hands each local term the gradient as it is, since
    every rank backpropagates the same replicated value."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.devices = [x.device for x in xs]
        return _sum_in_order(_global_terms(mesh, xs))

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(d) for d in ctx.devices))


class _AllGather(torch.autograd.Function):
    """Every shard's block concatenated along ``dim`` on the first local
    device; the backward sums the ranks' gradients and hands each local
    block its slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        ctx.devices = [x.device for x in xs]
        ctx.width = xs[0].shape[dim]
        return torch.cat(_global_terms(mesh, xs), dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous(), ctx.mesh.group)
        blocks = total.split(ctx.width, ctx.dim)
        return (None, None, *(blocks[s].to(d) for s, d in
                              zip(ctx.mesh.shards, ctx.devices)))


class _ScatterRows(torch.autograd.Function):
    """This rank's blocks of a replicated ``x``; the backward gathers every
    block's gradient, the whole gradient of ``x`` on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.device = mesh, dim, x.device
        blocks = x.split(x.shape[dim] // mesh.size, dim)
        ctx.shape = blocks[0].shape
        return tuple(blocks[s].to(d, copy=True).contiguous()
                     for s, d in zip(mesh.shards, mesh.devices))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(ctx.shape, device=d) if g is None else g
              for g, d in zip(gs, ctx.mesh.devices)]
        terms = _global_terms(ctx.mesh, gs)
        return torch.cat(terms, ctx.dim).to(ctx.device), None, None


def _all_to_all(mesh: Mesh, sends: list[torch.Tensor]) -> list:
    """Mesh.all_to_all over the ranks: rank q receives from each rank the
    [L, L, C, ...] blocks that its shards send to q's shards (one
    ``all_to_all_single``: gloo has no list all_to_all)."""
    backend = _backend()
    world, per = mesh.ranks, len(mesh.shards)
    root = mesh.devices[0]
    stacked = torch.stack([s.to(root) for s in sends])    # [L, S, C, ...]
    send = stacked.unflatten(1, (world, per)).transpose(0, 1).contiguous()
    src = _staged(send, backend)                          # [W, L, L, C, ...]
    out = _buffers(src, 1)[0]
    t0 = time.perf_counter()
    tdist.all_to_all_single(out, src, group=_process_group(mesh.group))
    TRANSPORT["comm_s"] += time.perf_counter() - t0
    TRANSPORT["calls"] += 1
    TRANSPORT["bytes"] += send.numel() * send.element_size()
    recv = _returned([out], root)[0].flatten(0, 1)        # [S, L, C, ...]
    return [recv[:, i].to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def _card_key(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{props.name}/{props.uuid}"


def refuse_shared_cards(keys: list[str]) -> None:
    """Raise when two ranks of an NCCL job name one card (``keys[r]``:
    rank r's card)."""
    first = {}
    for r, key in enumerate(keys):
        if key in first:
            raise RuntimeError(
                f"NCCL cannot run two ranks on one card: ranks "
                f"{first[key]} and {r} are both on {key}. Ranks that share "
                f"a card run with the gloo backend "
                f"(init_process_group('gloo')), which stages the card's "
                f"tensors through host memory")
        first[key] = r


def _check_transport(device: torch.device) -> None:
    backend = _backend()
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the nccl backend moves card tensors: a mesh of "
                         "CPU shards needs the gloo backend")
    # asked over gloo: NCCL itself would fail on such a job at its first
    # collective
    side = tdist.new_group(backend="gloo")
    keys = [None] * tdist.get_world_size()
    tdist.all_gather_object(keys, _card_key(device), group=side)
    tdist.destroy_process_group(side)
    refuse_shared_cards(keys)


def _process_mesh(n_data, n_model, devices, device) -> Mesh:
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
    total = (world * (len(devices) if devices else 1) if n_data is None
             else n_data * n_model)
    if total % n_model:
        raise ValueError(f"{total} shards do not make rows of {n_model}")
    if total % world:
        raise ValueError(f"{total} shards do not divide over the "
                         f"{world} processes")
    per = total // world
    if per % n_model and n_model % per:
        raise ValueError(
            f"a rank holds {per} shards: a process mesh puts whole data "
            f"rows of {n_model} model shards on a rank, or a rank's shards "
            f"in one row")
    if devices is None:
        devices = [resolve_device(device)] * per
    if len(devices) < per:
        raise ValueError(f"need {per} devices on rank {rank}, have "
                         f"{len(devices)}")
    devices = [_indexed(d) for d in devices[:per]]
    if len(set(devices)) != 1:
        raise ValueError(
            f"a process mesh puts a rank's shards on one device (the "
            f"backward's collectives then run on one autograd thread, in "
            f"the same order on every rank), not {devices}")
    _check_transport(devices[0])
    mesh = Mesh(tuple(devices), tuple(range(rank * per, (rank + 1) * per)),
                world, rank, n_model)
    if n_model % per == 0 and n_model > per:
        # the data groups (one a block of model columns), then the model
        # groups (one a data row), the same on every rank
        q, n_rows = n_model // per, total // n_model
        _make_groups([tuple(j + i * q for i in range(n_rows))
                      for j in range(q)]
                     + [tuple(range(d * q, (d + 1) * q))
                        for d in range(n_rows)])
    return mesh


def _indexed(d: torch.device) -> torch.device:
    # "cuda" and "cuda:<current>" are one card: name each by its index
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device="cuda") -> Mesh:
    """A mesh of ``n_data`` x ``n_model`` shards, shard ``d * n_model + m``
    at data row d and model column m (grandtpu's grid).

    In one process: ``devices`` are the devices in shard order (repeats
    allowed); by default the first ``n_data * n_model`` visible cards, or
    that many times the CPU when ``device`` is "cpu". Raises when there
    are fewer cards than shards (no quiet fall-back to sharing one).
    ``n_data`` defaults to the devices (or cards) over ``n_model``.

    Once ``torch.distributed`` is initialized with a world size above 1,
    the mesh spans the ranks: its shards (default: one a rank) must divide
    by the world size, a rank holding whole data rows or a part of one,
    and this rank holds its contiguous ``S / world`` shards, on its
    current card (``torch.cuda.current_device()``, which ``torchrun``
    users set), on the CPU with ``device="cpu"``, or on ``devices`` (this
    rank's). The groups of the rows and columns that span ranks are made
    here, on every rank."""
    if n_model < 1:
        raise ValueError(f"n_model {n_model}")
    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_world_size() > 1:
        return _process_mesh(n_data, n_model, devices, device)
    if devices is None:
        device = resolve_device(device)
        if device.type == "cpu":
            devices = [device] * ((n_data or 1) * n_model)
        else:
            count = torch.cuda.device_count()
            n = count if n_data is None else n_data * n_model
            if n > count:
                raise ValueError(f"need {n} CUDA devices, have {count}; "
                                 "list the devices to share one")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    n = n_data * n_model
    if not 0 < n <= len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(tuple(_indexed(d) for d in devices[:n]), n_model=n_model)
