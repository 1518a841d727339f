"""The port's device mesh (port of ``grandtpu/dist/mesh.py``).

A :class:`Mesh` is S shards on the data axis. grandtpu's mesh spans every
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

The transport follows the process group's backend, with no fall-back
from one to the other: ``nccl`` takes card tensors as they are (a CPU
tensor goes through the rank's card), ``gloo`` stages card tensors
through pinned host memory. NCCL refuses two ranks on one card, so
:func:`make_mesh` raises on such a job and names gloo, which runs it.
:data:`TRANSPORT` counts the collectives and their seconds. Tensor
parallelism is ROADMAP Queue A 24.
"""

from __future__ import annotations

import dataclasses
import socket
import time

import torch
import torch.distributed as tdist

from grandtpu_torch.device import resolve_device

_TP = ("ROADMAP Queue A 24: tensor parallelism (_shard_params_tp, "
       "emb_mode='tp'), split from ROADMAP Queue A 8")

# the cross-process collectives of this process: calls, bytes sent, and
# the seconds of gloo's staging copies and of the collectives themselves
TRANSPORT = {"calls": 0, "bytes": 0, "stage_s": 0.0, "comm_s": 0.0}


def reset_transport() -> None:
    TRANSPORT.update(calls=0, bytes=0, stage_s=0.0, comm_s=0.0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards on the data axis: ``devices[i]`` holds shard ``shards[i]``
    (default: every shard, 0..len(devices)-1, in one process). On a mesh
    over ``ranks`` processes this process, rank ``rank``, holds the
    shards ``shards``."""
    devices: tuple[torch.device, ...]
    shards: tuple[int, ...] | None = None
    ranks: int = 1
    rank: int = 0

    def __post_init__(self):
        if self.shards is None:
            object.__setattr__(self, "shards",
                               tuple(range(len(self.devices))))

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "model": 1}

    @property
    def size(self) -> int:
        """The global shard count."""
        return len(self.shards) * self.ranks

    @property
    def multiprocess(self) -> bool:
        return self.ranks > 1

    def per_device(self, make):
        """``make(device)`` once for each distinct local device, in shard
        order (shards on one device share the result)."""
        made = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    def all_gather(self, xs: list[torch.Tensor],
                   dim: int = 0) -> list[torch.Tensor]:
        """Each shard's block, concatenated in shard order along ``dim`` on
        every shard's device ([S * r, ...] for dim 0); shards on one device
        share the copy, which they must only read. Differentiable: the
        backward sums each copy's gradient slices back onto their shards
        (a reduce-scatter)."""
        if self.multiprocess:
            out = _apply(_AllGather, xs, self, dim)
            return self.per_device(lambda d: out.to(d))
        return self.per_device(
            lambda d: torch.cat([x.to(d) for x in xs], dim))

    def broadcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` (on any device; on a process mesh the same on every rank)
        on every local shard's device; shards on one device share it. The
        backward sums the shards' gradients (a reduce onto ``x``'s device,
        then over the ranks)."""
        if self.multiprocess and _needs_grad(x):
            x = _SumGrads.apply(x)
        return self.per_device(lambda d: x.to(d))

    def reduce_sum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's tensor on the first local device, added
        in shard order (the same bits on every rank). The backward hands
        the gradient to each shard."""
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
        return self.broadcast(self.reduce_sum(xs))

    def scatter_rows(self, x: torch.Tensor,
                     dim: int = 0) -> list[torch.Tensor]:
        """``x``'s S equal blocks along ``dim``, block s on shard s's
        device, contiguous (the kernels take them as they are); on a
        process mesh ``x`` is the same on every rank and each rank gets its
        own blocks. The backward gathers the blocks' gradients."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             "shards")
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
        return self.scatter_rows(self.reduce_sum(xs), dim)

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[s]`` [S, C, ...] holds what shard s sends to each shard;
        shard d receives ``stack_s(sends[s][d])`` [S, C, ...] on its
        device (grandtpu's ``lax.all_to_all`` with split and concat axis
        0, untiled)."""
        if self.multiprocess:
            return _all_to_all(self, sends)
        return [torch.stack([send[d].to(dev) for send in sends])
                for d, dev in enumerate(self.devices)]

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise max of every shard's tensor, on every shard's
        device."""
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
        (on a process mesh the whole result on every rank)."""
        if self.multiprocess:
            xs = _global_terms(self, xs)
        return torch.cat([x.to(self.devices[0]) for x in xs])


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


def all_gather_tensor(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (the same shape on every rank), in rank order, on
    ``t``'s device."""
    backend = _backend()
    src = _staged(t.contiguous(), backend)
    outs = _buffers(src, tdist.get_world_size())
    t0 = time.perf_counter()
    tdist.all_gather(outs, src)
    TRANSPORT["comm_s"] += time.perf_counter() - t0
    TRANSPORT["calls"] += 1
    TRANSPORT["bytes"] += t.numel() * t.element_size()
    return _returned(outs, t.device)


def _global_terms(mesh: Mesh, xs: list[torch.Tensor]) -> list:
    """Every shard's tensor in global shard order, on the first local
    device (the local ones stacked, then gathered over the ranks)."""
    root = mesh.devices[0]
    stacked = torch.stack([x.detach().to(root) for x in xs])
    return [t for part in all_gather_tensor(stacked) for t in part.unbind()]


def _sum_in_order(terms: list[torch.Tensor]) -> torch.Tensor:
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order."""
    return _sum_in_order(all_gather_tensor(t))


class _SumGrads(torch.autograd.Function):
    """The identity on a replicated value; the backward sums the ranks'
    gradients (broadcast's adjoint across processes)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous())


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
        total = _all_reduce(g.contiguous())
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
    tdist.all_to_all_single(out, src)
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


def _process_mesh(n_data, devices, device) -> Mesh:
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = world * (len(devices) if devices else 1)
    if n_data % world:
        raise ValueError(f"{n_data} shards do not divide over the "
                         f"{world} processes")
    per = n_data // world
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
    return Mesh(tuple(devices), tuple(range(rank * per, (rank + 1) * per)),
                world, rank)


def _indexed(d: torch.device) -> torch.device:
    # "cuda" and "cuda:<current>" are one card: name each by its index
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device="cuda") -> Mesh:
    """A mesh of ``n_data`` shards on the data axis.

    In one process: ``devices`` are the devices in shard order (repeats
    allowed); by default the first ``n_data`` visible cards, or
    ``n_data`` times the CPU when ``device`` is "cpu". Raises when there
    are fewer cards than ``n_data`` (no quiet fall-back to sharing one).

    Once ``torch.distributed`` is initialized with a world size above 1,
    the mesh spans the ranks: ``n_data`` (default: one shard a rank) is the
    global shard count and must divide by the world size, and this rank
    holds its ``n_data / world`` shards, on its current card
    (``torch.cuda.current_device()``, which ``torchrun`` users set), on
    the CPU with ``device="cpu"``, or on ``devices`` (this rank's).

    ``n_model > 1`` (tensor parallel) is not ported."""
    if n_model != 1:
        raise NotImplementedError(f"n_model > 1 is not ported yet ({_TP})")
    if tdist.is_available() and tdist.is_initialized() \
            and tdist.get_world_size() > 1:
        return _process_mesh(n_data, devices, device)
    if devices is None:
        device = resolve_device(device)
        if device.type == "cpu":
            devices = [device] * (n_data or 1)
        else:
            count = torch.cuda.device_count()
            n = count if n_data is None else n_data
            if n > count:
                raise ValueError(f"need {n} CUDA devices, have {count}; "
                                 "list the devices to share one")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if not 0 < n_data <= len(devices):
        raise ValueError(f"need {n_data} devices, have {len(devices)}")
    return Mesh(tuple(_indexed(d) for d in devices[:n_data]))
