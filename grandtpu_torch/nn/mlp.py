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


def _node_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (1e-12 + ||x||), the reference's epsilon placement."""
    return x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def _dropout(x, rate: float, training: bool, generator):
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


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


def init_mlp(cfg: MLPConfig, seed: int, device) -> MLP:
    """A fresh MLP on ``device``, its weights drawn on the CPU from a
    generator seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MLP(cfg).reset_parameters(g).to(device)
