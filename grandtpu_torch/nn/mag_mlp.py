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
table over a mesh's data axis by vocabulary rows (``table_shards``, one
``nn.Parameter`` a data row on the device of its first local shard, on
a mesh over processes for this process's data rows only, replicated over
'model', the vocabulary row-padded with zero rows to a multiple of the
data rows, as grandtpu's ``emb_mode="vocab"``);
:meth:`MagMLP.shard_columns` splits its columns over the mesh's 'model'
axis instead (``table_columns``, [V, H/m] a local model column, as
grandtpu's ``emb_mode="tp"``), and the head's first fc becomes
row-parallel on the embedding's column blocks (with one layer the table
maps to classes and its column blocks are joined over 'model');
:meth:`MagMLP.forward_sharded` is the head over the shards' row blocks,
as ``MLP.forward_sharded``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grandtpu_torch.nn.mlp import (MaskedBatchNorm, MLPConfig, _check_width,
                                   _dropout, _dropout_sharded,
                                   _linear_sharded, _node_normalize,
                                   _node_normalize_sharded, split_fc,
                                   split_parameters)
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
        self.model_mesh = None      # set by shard_columns

    def shard_vocab(self, mesh) -> "MagMLP":
        """Split ``table`` [V, H] over ``mesh``'s data axis by rows, in
        place: the table becomes ``table_shards``, one for each of this
        process's data rows, row d holding the rows :meth:`vocab_window`
        (d) of the vocabulary padded with zero rows to a multiple of the
        data rows, on the device of the first of its row's local shards
        (every model shard of the row reads it)."""
        blocks = mesh.row_blocks(self.table.detach())
        del self.table
        self.table_shards = nn.ParameterList(
            nn.Parameter(b.to(mesh.devices[mesh.data_shards.index(d)],
                              copy=True))
            for b, d in zip(blocks, dict.fromkeys(mesh.data_shards)))
        self.vocab_mesh = mesh
        return self

    def shard_columns(self, mesh) -> "MagMLP":
        """Split ``table`` [V, out] over ``mesh``'s 'model' axis by columns,
        in place: ``table_columns``, one [V, out/m] block a local model
        column on the device of the first of its column's shards, and the
        head's first fc row-parallel. Raises when ``out`` (the hidden
        width, or the classes with one layer) does not divide."""
        table = self.table.detach()
        _check_width(table.shape[1], mesh, "the table's width")
        del self.table
        self.table_columns = nn.ParameterList(
            nn.Parameter(b.to(mesh.devices[mesh.model_shards.index(c)],
                              copy=True).contiguous())
            for b, c in zip(mesh.column_blocks(table, 1),
                            mesh.local_columns))
        if self.fcs:
            split_fc(self.fcs[0], mesh, 1)
        self.model_mesh = mesh
        return self

    def table_blocks(self):
        """(blocks, join, cut) of a sharded table as ``split_parameters``
        gives them (vocab rows, or column blocks), or None for a whole
        one."""
        if self.model_mesh is not None:
            mesh = self.model_mesh
            return (list(self.table_columns),
                    lambda ts: mesh.gather_columns(ts, 1),
                    lambda t: mesh.column_blocks(t, 1))
        if self.vocab_mesh is not None:
            mesh = self.vocab_mesh
            return (list(self.table_shards), mesh.gather_row_blocks,
                    mesh.row_blocks)
        return None

    def sharded_parameters(self) -> list:
        """The parameters of which each rank holds only its own blocks (a
        vocab-sharded table, or the column blocks over 'model')."""
        return [p for blocks, *_ in split_parameters(self).values()
                for p in blocks]

    def vocab_window(self, d: int) -> tuple[int, int]:
        """The rows [lo, hi) of the (padded) vocabulary data row d holds."""
        per = self.table_shards[0].shape[0]
        return d * per, (d + 1) * per

    def gathered_table(self) -> torch.Tensor:
        """The whole table (with a sharded one's zero padding rows) on the
        first device, detached. On a mesh over processes a collective:
        every rank calls it and receives the whole table."""
        split = self.table_blocks()
        if split is None:
            return self.table.detach()
        blocks, join, _ = split
        return join(blocks)

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
        if self.model_mesh is not None:
            raise ValueError("a MagMLP split over 'model' runs "
                             "forward_sharded")
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
        ``MLP.forward_sharded``). With the table's columns split over
        'model', ``xs`` are each model shard's column blocks; the logits
        are replicated over 'model'."""
        cfg = self.cfg
        split = split or mesh.scatter_rows
        columns = self.model_mesh is not None
        for fc, bn in zip(self.fcs, self.bns):
            xs = [torch.relu(x) for x in xs]
            if cfg.node_norm:
                xs = _node_normalize_sharded(mesh, xs, columns)
            if cfg.use_bn:
                xs = bn.forward_sharded(mesh, xs, batch_masks, columns)
            xs = _dropout_sharded(mesh, xs, cfg.hidden_droprate,
                                  self.training, generator, split, columns)
            xs = _linear_sharded(mesh, fc, xs, columns)
            columns = False
        if columns:
            xs = mesh.model_all_gather(xs, -1)
        return xs


def init_mag_mlp(cfg: MLPConfig, seed: int, device) -> MagMLP:
    """A fresh MagMLP on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    g = torch.Generator().manual_seed(seed)
    return MagMLP(cfg).reset_parameters(g).to(device)
