"""The MAG model: embedding table input + MLP head, as an ``nn.Module``.

Port of ``grandtpu/nn/mag_mlp.py`` (reference ``model_mag.py:17-90``).
``num_features`` is the attr vocabulary size; the input layer is the
embedding weighted mean (:mod:`grandtpu_torch.nn.sparse_input`, kernel
K3), and the head applies, per fc layer: relu -> [node_norm] ->
[masked BN] -> hidden dropout -> fc. The relu comes first (the embedding
output is pre-activation), node_norm is not detached, and there is no
input BatchNorm: the layout differs from the dense ``MLP``. With
``nlayers == 1`` the table maps straight to classes and the head is the
identity. As in ``grandtpu``, the BatchNorms exist whatever ``use_bn``
says and are applied only when it is set.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grandtpu_torch.nn.mlp import (MaskedBatchNorm, MLPConfig, _dropout,
                                   _node_normalize)
from grandtpu_torch.nn.sparse_input import init_embedding


class MagMLP(nn.Module):
    def __init__(self, cfg: MLPConfig):
        super().__init__()
        self.cfg = cfg
        out_dim = cfg.num_classes if cfg.nlayers == 1 else cfg.hidden
        self.table = nn.Parameter(torch.empty(cfg.num_features, out_dim))
        h, c = cfg.hidden, cfg.num_classes
        dims = ([(h, h)] * (cfg.nlayers - 2) + [(h, c)]
                if cfg.nlayers >= 2 else [])
        self.fcs = nn.ModuleList(nn.Linear(i, o) for i, o in dims)
        self.bns = nn.ModuleList(MaskedBatchNorm(h) for _ in dims)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "MagMLP":
        self.table.copy_(init_embedding(*self.table.shape, generator))
        for fc in self.fcs:
            bound = 1.0 / math.sqrt(fc.in_features)
            fc.weight.uniform_(-bound, bound, generator=generator)
            fc.bias.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, x: torch.Tensor, batch_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The head on [B, H] embeddings -> [B, C] logits. ``batch_mask``
        ([B] 0/1) marks real rows for the BN statistics; ``generator``
        draws the hidden dropout."""
        cfg = self.cfg
        for fc, bn in zip(self.fcs, self.bns):
            x = torch.relu(x)
            if cfg.node_norm:
                x = _node_normalize(x)
            if cfg.use_bn:
                x = bn(x, batch_mask)
            x = _dropout(x, cfg.hidden_droprate, self.training, generator)
            x = fc(x)
        return x


def init_mag_mlp(cfg: MLPConfig, seed: int, device) -> MagMLP:
    """A fresh MagMLP on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MagMLP(cfg).reset_parameters(g).to(device)
