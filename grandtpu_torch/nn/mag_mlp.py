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

For data-parallel training (D2) :meth:`MagMLP.shard_vocab` splits the
table over a mesh's shards by vocabulary rows (``table_shards``, one
``nn.Parameter`` a shard on its device, on a mesh over processes for
this process's shards only, the vocabulary row-padded with
zero rows to a multiple of S, as grandtpu's ``emb_mode="vocab"``);
:meth:`MagMLP.forward_sharded` is the head over the shards' row blocks,
as ``MLP.forward_sharded``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grandtpu_torch.nn.mlp import (MaskedBatchNorm, MLPConfig, _dropout,
                                   _dropout_sharded, _linear_sharded,
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
        self.vocab_mesh = None      # set by shard_vocab

    def shard_vocab(self, mesh) -> "MagMLP":
        """Split ``table`` [V, H] over ``mesh``'s shards by rows, in place:
        the table becomes ``table_shards``, one for each of this process's
        shards, shard s holding the rows :meth:`vocab_window` (s) of the
        vocabulary padded with zero rows to a multiple of S, on its
        device."""
        table = self.table.detach()
        v, h = table.shape
        per = -(-v // mesh.size)
        padded = torch.cat([table, table.new_zeros(per * mesh.size - v, h)])
        blocks = padded.split(per)
        del self.table
        self.table_shards = nn.ParameterList(
            nn.Parameter(blocks[s].to(d, copy=True))
            for s, d in zip(mesh.shards, mesh.devices))
        self.vocab_mesh = mesh
        return self

    def vocab_window(self, s: int) -> tuple[int, int]:
        """The rows [lo, hi) of the (padded) vocabulary shard s holds."""
        per = self.table_shards[0].shape[0]
        return s * per, (s + 1) * per

    def gathered_table(self) -> torch.Tensor:
        """The whole table (with a sharded one's zero padding rows) on the
        first device, detached. On a mesh over processes a collective:
        every rank calls it and receives the whole table."""
        if self.vocab_mesh is None:
            return self.table.detach()
        return self.vocab_mesh.gather_rows(
            [t.detach() for t in self.table_shards])

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

    def forward_sharded(self, mesh, xs: list, batch_masks: list | None = None,
                        generator: torch.Generator | None = None,
                        split=None) -> list:
        """The head on the shards' [b_s, H] embeddings, equal to
        :meth:`forward` on the batch they make up (arguments as
        ``MLP.forward_sharded``)."""
        cfg = self.cfg
        split = split or mesh.scatter_rows
        for fc, bn in zip(self.fcs, self.bns):
            xs = [torch.relu(x) for x in xs]
            if cfg.node_norm:
                xs = [_node_normalize(x) for x in xs]
            if cfg.use_bn:
                xs = bn.forward_sharded(mesh, xs, batch_masks)
            xs = _dropout_sharded(mesh, xs, cfg.hidden_droprate,
                                  self.training, generator, split)
            xs = _linear_sharded(mesh, fc, xs)
        return xs


def init_mag_mlp(cfg: MLPConfig, seed: int, device) -> MagMLP:
    """A fresh MagMLP on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MagMLP(cfg).reset_parameters(g).to(device)
