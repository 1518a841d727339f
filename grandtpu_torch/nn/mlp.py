"""The GRAND+ MLP classifier as an ``nn.Module``.

Port of ``grandtpu/nn/mlp.py`` (reference ``model.py:17-67``):

- nlayers == 1: Linear(F, C); optional input BatchNorm(F)
- nlayers >= 2: Linear(F, H), (nlayers-2) x Linear(H, H), Linear(H, C);
  BatchNorms on the input and each hidden width
- forward: [node_norm (detached at the input)] -> [BN] -> dropout -> fc,
  then per hidden layer: relu -> [node_norm] -> [BN] -> dropout -> fc

BatchNorm is not ``nn.BatchNorm1d``: train mode takes *mask-weighted*
batch statistics, so a wrap-padded partial batch normalizes and updates
the running stats exactly like the true smaller batch. The running
variance is unbiased by m/(m-1) with m the mask count; eval mode uses the
running stats. The BatchNorms exist whatever ``use_bn`` says, as in the
reference and in ``grandtpu``'s parameter tree; they are applied only when
it is set. Linear init is U(+-1/sqrt(fan_in)) for weight and bias, drawn
from the caller's generator.

:meth:`MLP.forward_sharded` is the same forward over the row blocks of one
batch on the shards of a mesh (data-parallel training), equal to
:meth:`MLP.forward` on the whole batch: each shard reads the parameters
through the mesh's differentiable broadcast (so autograd sums the shards'
gradients), dropout masks are drawn at the batch's shape in ``forward``'s
order and handed out by rows, and train-mode BatchNorm takes its masked
moments over the mesh (mean first, then the centered sums; only
[width]-sized partials cross the shards) and updates its running stats
once.

:meth:`MLP.shard_hidden` splits the hidden width over the mesh's 'model'
axis (tensor parallelism, grandtpu's ``_shard_params_tp``): ``fcs[0]``
becomes column-parallel (``weight_shards`` [H/m, F] and ``bias_shards``
[H/m], one a local model column) and every later fc row-parallel
(``weight_shards`` [out, H/m], its ``bias`` replicated). The hidden
activation after ``fcs[0]`` is then a column block on each model shard:
its node_norm sums the squares over 'model' (``model_all_reduce`` with
``model_copy``'s summed gradient, since each shard's block follows), its
BatchNorm takes per-column moments over 'data' on its slice of the
replicated weight, bias and running stats, and its dropout mask is drawn
at [B, H] and handed out by rows and columns. A row-parallel fc sums its
shards' partial products over 'model' (``model_all_reduce``) and adds its
bias after; on a replicated input (layers 2 on) each shard first takes
its column block (``model_split``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    num_features: int
    num_classes: int
    hidden: int
    nlayers: int
    use_bn: bool = False
    node_norm: bool = False
    input_droprate: float = 0.0
    hidden_droprate: float = 0.0


def layer_dims(cfg: MLPConfig):
    """[(in, out), ...] for fcs and [dim, ...] for bns, reference layout."""
    f, h, c, L = cfg.num_features, cfg.hidden, cfg.num_classes, cfg.nlayers
    if L == 1:
        return [(f, c)], [f]
    fcs = [(f, h)] + [(h, h)] * (L - 2) + [(h, c)]
    bns = [f] + [h] * (L - 2) + [h]
    return fcs, bns


class MaskedBatchNorm(nn.Module):
    """torch BatchNorm1d semantics with optional [B] 0/1 row weights for
    the train-mode batch statistics."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        if self.training:
            if mask is None:
                m = x.shape[0]
                mean = x.mean(0)
                var = x.var(0, unbiased=False)
                unbiased = var * (m / max(m - 1, 1))
            else:
                m = mask.sum().clamp(min=1.0)
                mean = (x * mask[:, None]).sum(0) / m
                var = (((x - mean) ** 2) * mask[:, None]).sum(0) / m
                unbiased = var * (m / (m - 1.0).clamp(min=1.0))
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + BN_EPS)
        return y * self.weight + self.bias

    def forward_sharded(self, mesh, xs: list, masks: list | None = None,
                        columns: bool = False) -> list:
        """:meth:`forward` over the shards' row blocks ``xs`` (with their
        [b_s] row weights ``masks``), with the batch's moments. With
        ``columns`` each model shard holds its column block of the width:
        it reads its slice of the weight, bias and running stats, and the
        running stats update once from the joined moments."""
        def read(t):
            ts = mesh.broadcast(t)
            return mesh.model_split(ts, 0) if columns else ts

        if self.training:
            if masks is None:
                masks = [x.new_ones(x.shape[0]) for x in xs]
            m = [c.clamp(min=1.0) for c in
                 mesh.all_reduce_sum([mk.sum() for mk in masks])]
            sums = mesh.all_reduce_sum([(x * mk[:, None]).sum(0)
                                        for x, mk in zip(xs, masks)])
            means = [a / c for a, c in zip(sums, m)]
            sq = mesh.all_reduce_sum([(((x - mu) ** 2) * mk[:, None]).sum(0)
                                      for x, mu, mk in zip(xs, means, masks)])
            vars_ = [a / c for a, c in zip(sq, m)]
            with torch.no_grad():
                mean, var = means[0], vars_[0]
                if columns:
                    mean = mesh.model_all_gather(means, 0)[0]
                    var = mesh.model_all_gather(vars_, 0)[0]
                unbiased = var * (m[0] / (m[0] - 1.0).clamp(min=1.0))
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * mean.to(self.running_mean.device))
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * unbiased.to(self.running_var.device))
        else:
            means, vars_ = read(self.running_mean), read(self.running_var)
        ws, bs = read(self.weight), read(self.bias)
        return [(x - mu) * torch.rsqrt(v + BN_EPS) * w + b
                for x, mu, v, w, b in zip(xs, means, vars_, ws, bs)]


def _node_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (1e-12 + ||x||), the reference's epsilon placement."""
    return x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def _node_normalize_sharded(mesh, xs: list, columns: bool) -> list:
    """:func:`_node_normalize` of each shard's rows; with ``columns`` the
    rows' squares summed over 'model' first (the norm of a row of 0 has
    the gradient 0, as ``vector_norm``'s)."""
    if not columns:
        return [_node_normalize(x) for x in xs]
    sq = mesh.model_copy(mesh.model_all_reduce(
        [(x * x).sum(-1, keepdim=True) for x in xs]))
    norms = [torch.where(s > 0, torch.where(s > 0, s, 1.0).sqrt(), 0.0)
             for s in sq]
    return [x / (1e-12 + n) for x, n in zip(xs, norms)]


def _dropout(x, rate: float, training: bool, generator):
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _dropout_sharded(mesh, xs: list, rate: float, training: bool, generator,
                     split, columns: bool = False) -> list:
    """:func:`_dropout` of the batch the mesh's equal row blocks ``xs``
    (this process's) make up: one mask of the batch's shape drawn on the
    generator's device, handed out by ``split`` (batch rows -> the shards'
    blocks), and with ``columns`` by the model shards' column blocks."""
    if not training or rate <= 0.0:
        return xs
    n = mesh.n_model if columns else 1
    shape = (xs[0].shape[0] * mesh.n_data, xs[0].shape[1] * n)
    keeps = split(torch.rand(shape, generator=generator,
                             device=generator.device) < 1.0 - rate)
    if columns:
        w = xs[0].shape[1]
        keeps = [k[:, m * w:(m + 1) * w]
                 for k, m in zip(keeps, mesh.model_shards)]
    return [torch.where(k, x / (1.0 - rate), 0.0) for k, x in zip(keeps, xs)]


def _linear_sharded(mesh, fc: nn.Linear, xs: list,
                    columns: bool = False) -> list:
    """``fc`` on each shard's rows: replicated, or over 'model' when split
    (:meth:`MLP.shard_hidden`): column-parallel on a replicated input (its
    output a column block), or row-parallel on the column blocks of its
    input (``columns``) or of its replicated input (split here), summed
    over 'model', then its bias."""
    linear = torch.nn.functional.linear
    shards = getattr(fc, "weight_shards", None)
    if shards is None:
        return [linear(x, w, b) for x, w, b in
                zip(xs, mesh.broadcast(fc.weight), mesh.broadcast(fc.bias))]
    ws = mesh.broadcast_columns(list(shards))
    if hasattr(fc, "bias_shards"):
        # each model shard reads all of the replicated input: its gradient
        # is the sum of theirs (f)
        xs = mesh.model_copy(xs)
        return [linear(x, w, b) for x, w, b in
                zip(xs, ws, mesh.broadcast_columns(list(fc.bias_shards)))]
    if not columns:
        xs = mesh.model_split(xs, -1)
    sums = mesh.model_all_reduce([linear(x, w) for x, w in zip(xs, ws)])
    return [y + b for y, b in zip(sums, mesh.broadcast(fc.bias))]


def _check_width(width: int, mesh, what: str) -> None:
    if width % mesh.n_model:
        raise ValueError(f"{what} {width} does not divide over the mesh's "
                         f"{mesh.n_model} model shards")


def split_fc(fc: nn.Linear, mesh, dim: int) -> None:
    """Split ``fc`` over ``mesh``'s model columns in place: its weight along
    ``dim`` (0: column-parallel, the bias split too; 1: row-parallel),
    one ``nn.Parameter`` block a local model column, on the device of the
    first of its column's local shards."""
    devices = [mesh.devices[mesh.model_shards.index(c)]
               for c in mesh.local_columns]

    def blocks(t, d):
        _check_width(t.shape[d], mesh, "a width of")
        return nn.ParameterList(
            nn.Parameter(part.to(dev, copy=True)) for part, dev in
            zip(mesh.column_blocks(t.detach(), d), devices))

    weight = blocks(fc.weight, dim)
    del fc.weight
    fc.weight_shards = weight
    if dim == 0:
        bias = blocks(fc.bias, 0)
        del fc.bias
        fc.bias_shards = bias


def _fc_split(fc: nn.Linear, mesh) -> dict:
    """{"weight" / "bias": (its blocks, join, cut)} of each parameter of
    ``fc`` split over 'model' (:func:`split_fc`); ``join`` and ``cut`` as
    :func:`split_parameters` says."""
    if not hasattr(fc, "weight_shards"):
        return {}

    def split(blocks, dim):
        return (list(blocks), functools.partial(mesh.gather_columns, dim=dim),
                functools.partial(mesh.column_blocks, dim=dim))

    column = hasattr(fc, "bias_shards")
    out = {"weight": split(fc.weight_shards, 0 if column else 1)}
    if column:
        out["bias"] = split(fc.bias_shards, 0)
    return out


def fc_tensors(fc: nn.Linear, mesh) -> tuple:
    """(weight [out, in], bias [out]) of ``fc`` whole and detached on the
    first local device, a split fc's blocks joined (a collective of the
    row's ranks when 'model' spans ranks)."""
    split = _fc_split(fc, mesh)
    out = []
    for k in ("weight", "bias"):
        if k in split:
            blocks, join, _ = split[k]
            out.append(join(blocks))
        else:
            out.append(getattr(fc, k).detach())
    return tuple(out)


def split_parameters(model) -> dict:
    """{whole name: (its blocks, join, cut)} of each parameter that
    ``model`` (an ``MLP`` or ``MagMLP``) holds in blocks over a mesh: the
    blocks are this process's ``nn.Parameter``s; ``join(tensors)``, given
    one tensor a block (their values, gradients or Adam moments), returns
    the whole tensor detached on the first local device (a collective when
    the blocks span ranks); ``cut(whole)`` is its inverse, one tensor a
    block (no collective)."""
    out = {f"fcs.{i}.{k}": v for i, fc in enumerate(model.fcs)
           for k, v in _fc_split(fc, model.model_mesh).items()}
    table = getattr(model, "table_blocks", lambda: None)()
    if table is not None:
        out["table"] = table
    return out


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig):
        super().__init__()
        self.cfg = cfg
        fc_dims, bn_dims = layer_dims(cfg)
        self.fcs = nn.ModuleList(nn.Linear(i, o) for i, o in fc_dims)
        self.bns = nn.ModuleList(MaskedBatchNorm(d) for d in bn_dims)
        self.model_mesh = None      # set by shard_hidden

    def shard_hidden(self, mesh) -> "MLP":
        """Split the hidden width over ``mesh``'s 'model' axis in place
        (grandtpu's ``_shard_params_tp``): ``fcs[0]`` column-parallel, every
        later fc row-parallel; with one layer nothing is split. Raises when
        the hidden width does not divide over 'model'."""
        if self.cfg.nlayers == 1:
            return self
        _check_width(self.cfg.hidden, mesh, "the hidden width")
        split_fc(self.fcs[0], mesh, 0)
        for fc in self.fcs[1:]:
            split_fc(fc, mesh, 1)
        self.model_mesh = mesh
        return self

    def sharded_parameters(self) -> list:
        """The parameters split over 'model' (each rank holds its own
        columns' blocks)."""
        return [p for blocks, *_ in split_parameters(self).values()
                for p in blocks]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "MLP":
        for fc in self.fcs:
            bound = 1.0 / math.sqrt(fc.in_features)
            fc.weight.uniform_(-bound, bound, generator=generator)
            fc.bias.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, x: torch.Tensor, batch_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits. ``batch_mask`` ([B] 0/1) marks real rows for the BN
        statistics of wrap-padded batches; ``generator`` draws dropout."""
        cfg = self.cfg
        if self.model_mesh is not None:
            raise ValueError("an MLP split over 'model' runs forward_sharded")
        if cfg.node_norm:
            x = _node_normalize(x).detach()
        if cfg.use_bn:
            x = self.bns[0](x, batch_mask)
        x = _dropout(x, cfg.input_droprate, self.training, generator)
        x = self.fcs[0](x)
        for i in range(1, cfg.nlayers):
            x = torch.relu(x)
            if cfg.node_norm:
                x = _node_normalize(x)
            if cfg.use_bn:
                x = self.bns[i](x, batch_mask)
            x = _dropout(x, cfg.hidden_droprate, self.training, generator)
            x = self.fcs[i](x)
        return x

    def forward_sharded(self, mesh, xs: list, batch_masks: list | None = None,
                        generator: torch.Generator | None = None,
                        split=None) -> list:
        """Logits of each shard's rows: ``xs[i]`` [b_s, F] are the rows of
        one batch of this process's shard i, on ``mesh.devices[i]``;
        ``batch_masks[i]`` their
        BN row weights. ``split`` hands a batch-shaped tensor's rows out to
        the shards (default: ``mesh.scatter_rows``, the batch in shard
        order); dropout draws from ``generator`` as :meth:`forward` does.
        Split over 'model', the first hidden activation is each model
        shard's column block and the logits are replicated over 'model'."""
        cfg = self.cfg
        split = split or mesh.scatter_rows
        if cfg.node_norm:
            xs = [_node_normalize(x).detach() for x in xs]
        if cfg.use_bn:
            xs = self.bns[0].forward_sharded(mesh, xs, batch_masks)
        xs = _dropout_sharded(mesh, xs, cfg.input_droprate, self.training,
                              generator, split)
        xs = _linear_sharded(mesh, self.fcs[0], xs)
        columns = self.model_mesh is not None
        for i in range(1, cfg.nlayers):
            xs = [torch.relu(x) for x in xs]
            if cfg.node_norm:
                xs = _node_normalize_sharded(mesh, xs, columns)
            if cfg.use_bn:
                xs = self.bns[i].forward_sharded(mesh, xs, batch_masks,
                                                 columns)
            xs = _dropout_sharded(mesh, xs, cfg.hidden_droprate,
                                  self.training, generator, split, columns)
            xs = _linear_sharded(mesh, self.fcs[i], xs, columns)
            columns = False
        return xs


def init_mlp(cfg: MLPConfig, seed: int, device) -> MLP:
    """A fresh MLP on ``device``, its weights drawn on the CPU from a
    generator seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MLP(cfg).reset_parameters(g).to(device)
