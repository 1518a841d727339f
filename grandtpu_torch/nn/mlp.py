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
"""

from __future__ import annotations

import dataclasses
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

    def forward_sharded(self, mesh, xs: list, masks: list | None = None
                        ) -> list:
        """:meth:`forward` over the shards' row blocks ``xs`` (with their
        [b_s] row weights ``masks``), with the batch's moments."""
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
                unbiased = vars_[0] * (m[0] / (m[0] - 1.0).clamp(min=1.0))
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * means[0].to(self.running_mean.device))
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    BN_MOMENTUM * unbiased.to(self.running_var.device))
        else:
            means = mesh.broadcast(self.running_mean)
            vars_ = mesh.broadcast(self.running_var)
        ws, bs = mesh.broadcast(self.weight), mesh.broadcast(self.bias)
        return [(x - mu) * torch.rsqrt(v + BN_EPS) * w + b
                for x, mu, v, w, b in zip(xs, means, vars_, ws, bs)]


def _node_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (1e-12 + ||x||), the reference's epsilon placement."""
    return x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def _dropout(x, rate: float, training: bool, generator):
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _dropout_sharded(xs: list, rate: float, training: bool, generator,
                     split) -> list:
    """:func:`_dropout` of the batch the row blocks ``xs`` make up: one
    mask of the batch's shape drawn on the generator's device, handed out
    by ``split`` (batch rows -> the shards' blocks)."""
    if not training or rate <= 0.0:
        return xs
    shape = (sum(x.shape[0] for x in xs), xs[0].shape[1])
    keeps = split(torch.rand(shape, generator=generator,
                             device=generator.device) < 1.0 - rate)
    return [torch.where(k, x / (1.0 - rate), 0.0) for k, x in zip(keeps, xs)]


def _linear_sharded(mesh, fc: nn.Linear, xs: list) -> list:
    return [torch.nn.functional.linear(x, w, b) for x, w, b in
            zip(xs, mesh.broadcast(fc.weight), mesh.broadcast(fc.bias))]


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig):
        super().__init__()
        self.cfg = cfg
        fc_dims, bn_dims = layer_dims(cfg)
        self.fcs = nn.ModuleList(nn.Linear(i, o) for i, o in fc_dims)
        self.bns = nn.ModuleList(MaskedBatchNorm(d) for d in bn_dims)

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
        """Logits of each shard's rows: ``xs[s]`` [b_s, F] are shard s's
        rows of one batch, on ``mesh.devices[s]``; ``batch_masks[s]`` their
        BN row weights. ``split`` hands a batch-shaped tensor's rows out to
        the shards (default: ``mesh.scatter_rows``, the batch in shard
        order); dropout draws from ``generator`` as :meth:`forward` does."""
        cfg = self.cfg
        split = split or mesh.scatter_rows
        if cfg.node_norm:
            xs = [_node_normalize(x).detach() for x in xs]
        if cfg.use_bn:
            xs = self.bns[0].forward_sharded(mesh, xs, batch_masks)
        xs = _dropout_sharded(xs, cfg.input_droprate, self.training,
                              generator, split)
        xs = _linear_sharded(mesh, self.fcs[0], xs)
        for i in range(1, cfg.nlayers):
            xs = [torch.relu(x) for x in xs]
            if cfg.node_norm:
                xs = [_node_normalize(x) for x in xs]
            if cfg.use_bn:
                xs = self.bns[i].forward_sharded(mesh, xs, batch_masks)
            xs = _dropout_sharded(xs, cfg.hidden_droprate, self.training,
                                  generator, split)
            xs = _linear_sharded(mesh, self.fcs[i], xs)
        return xs


def init_mlp(cfg: MLPConfig, seed: int, device) -> MLP:
    """A fresh MLP on ``device``, its weights drawn on the CPU from a
    generator seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MLP(cfg).reset_parameters(g).to(device)
