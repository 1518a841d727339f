"""Row-partitioned full-graph propagation, the all_gather variants (port of
``grandtpu/dist/spmm_shard.py``, the D1 programs).

The graph is cut into S contiguous row blocks, one shard each on the
mesh's devices. Every hop all-gathers the shards' carries, then each
shard computes its rows:

- :class:`ShardedPropagator` (grandtpu's scatter variant): K2-seg over the
  shard's padded COO rows (raw adjacency values, global columns), with
  ``D^-1`` and the update fused into its one launch a shard;
- :class:`BlockShardedPropagator` (the default variant): the K2 family on
  a rectangular CSR of the shard's rows over the gathered rows, ``D^-1``
  folded in: f32 → K2, bf16 → K2-bf16, int8 → the global per-column
  quantize (each shard's column max, the max over the mesh, each shard's
  quantize) before the all_gather, then K2-q8mxu where the rows are
  constant (they are for D^-1 A), else K2-q8; int8cast → K2-q8. The
  first hop's maxima come from each shard's ``column_absmax``; each later
  hop's from the maxima that every shard's hop raised while storing its
  rows (``amax_out``), then the max over the mesh.

grandtpu's TPU layout of the blocks (one-hot blocks, odd ``E_b``) is not
carried over; its row partition is (``rows_per`` rounded up to a multiple
of ``rows_per_block``), since it decides which rows each shard owns.
:func:`dist_exact_propagate` picks the variant as grandtpu does: by
default the all_gather variant on a one-process mesh, and the halo
exchange where it moves less than half the rows on a mesh over
processes. Every process holds its own shards' operators and receives the
whole [n, F] result, on its first device.

On a (data, model) mesh D1 runs along the axis ``axis``, as grandtpu's
``shard_map`` with ``P(axis, ...)``: the graph is cut into
``mesh.shape[axis]`` blocks, and every group of shards along the axis
(:meth:`Mesh.along`: along 'data' each model column, along 'model' each
data row) runs the 1-D propagator on its own 1-D mesh, its shards named
by their index along the axis. The groups are replicas: each computes the
whole result, bit for bit the 1-D mesh's, and the propagator returns the
first local group's (:meth:`AxisPropagator.each` returns every group's).
One block along the axis goes to the one-device propagator.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.dist.mesh import Mesh
from grandtpu_torch.infer.propagate import (_max_row_nnz,
                                            choose_fast_precision,
                                            exact_propagator)
from grandtpu_torch.sparse.spmm import (CSROperator, PaddedCSR,
                                        column_absmax, column_absmax_plain,
                                        quantize_with_amax,
                                        quantize_with_amax_plain,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_plain,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8_plain,
                                        spmm_prop_step_q8mxu,
                                        spmm_prop_step_q8mxu_plain,
                                        spmm_segment_prop_step,
                                        spmm_segment_prop_step_plain)

# the kernels a hop runs, or (plain=True) their plain versions on the same
# tensors, which chip_smoke.py holds the kernels' runs against on the card
_KERNELS = types.SimpleNamespace(
    k2=spmm_prop_step, k2_bf16=spmm_prop_step_bf16, q8=spmm_prop_step_q8,
    q8mxu=spmm_prop_step_q8mxu, absmax=column_absmax,
    quantize=quantize_with_amax, segment=spmm_segment_prop_step)
_PLAIN = types.SimpleNamespace(
    k2=spmm_prop_step_plain,
    k2_bf16=functools.partial(spmm_prop_step_plain, term="bf16"),
    q8=spmm_prop_step_q8_plain, q8mxu=spmm_prop_step_q8mxu_plain,
    absmax=column_absmax_plain, quantize=quantize_with_amax_plain,
    segment=spmm_segment_prop_step_plain)


class AxisPropagator:
    """A D1 propagator sharded along the mesh's axis ``axis`` and
    replicated over the other, as grandtpu's ``shard_map`` with ``P(axis,
    ...)``. On the 1-D mesh of its axis (a 1-D mesh along 'data') it runs
    the shards' own work (``_build``, ``_run``); on any other mesh it holds
    one such propagator for each group of shards that :meth:`Mesh.along`
    gives (``groups``), each computing the whole result, as grandtpu's
    replicas do, with the graph's shards named by their index along the
    axis. The groups run in ascending order, so that every rank reaches
    the collectives in the same order."""

    def __init__(self, mesh: Mesh, g, axis: str = "data"):
        groups = mesh.along(axis)
        if mesh.shape[axis] != g.num_shards:
            raise ValueError(f"the graph has {g.num_shards} shards, the "
                             f"mesh's axis {axis!r} {mesh.shape[axis]}")
        self.mesh, self.g = mesh, g
        subs = [sub for _, sub in groups.values()]
        if subs == [mesh]:
            self.groups = None
            self._build()
        else:
            self.groups = [type(self)(sub, g) for sub in subs]

    def each(self, x, **kw) -> list:
        """The [n, F] result of every local group, in order (one on the
        1-D mesh of the axis): the same bits in each."""
        if self.groups is None:
            return [self._run(x, **kw)]
        return [p._run(x, **kw) for p in self.groups]

    def __call__(self, x, **kw) -> torch.Tensor:
        """The first local group's [n, F] result, on its first device."""
        return self.each(x, **kw)[0]


def place(mesh: Mesh, num_nodes: int, rows_per: int, x) -> list:
    """[n, F] features (array or tensor) as f32 row blocks [rows_per, F],
    zero-padded to S * rows_per rows, one on each of this process's
    shards' devices."""
    x = torch.as_tensor(x, dtype=torch.float32)
    pad = torch.zeros((rows_per * mesh.size - num_nodes, x.shape[1]),
                      dtype=torch.float32, device=x.device)
    blocks = torch.cat([x, pad]).split(rows_per)
    return [blocks[s].to(d).contiguous()
            for s, d in zip(mesh.shards, mesh.devices)]


def _iterate(xs: list, hop, mode: str, order: int, alpha: float) -> list:
    """The power iteration of grandtpu's shard_map bodies on per-shard
    carries: ``hop(cur_in, cur_out, acc, scale, accumulate)`` runs one
    hop on every shard (lists, ``acc`` None when not accumulating)."""
    if mode == "ppr":
        cur_in = [x * alpha for x in xs]
        acc, scale, accumulate = [c.clone() for c in cur_in], 1.0 - alpha, True
    elif mode == "avg":
        cur_in = [x.clone() for x in xs]
        acc, scale, accumulate = [x.clone() for x in xs], 1.0, True
    elif mode == "single":
        cur_in, acc, scale, accumulate = [x.clone() for x in xs], None, 1.0, \
            False
    else:
        raise ValueError(f"unknown mode {mode!r}")
    cur_out = [torch.empty_like(c) for c in cur_in]
    for _ in range(order):
        hop(cur_in, cur_out, acc, scale, accumulate)
        cur_in, cur_out = cur_out, cur_in
    if mode == "ppr":
        return acc
    if mode == "avg":
        return [a.div_(float(order + 1)) for a in acc]
    return cur_in


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Adjacency split into S contiguous row blocks of ``rows_per_shard``
    rows; each shard's edges padded to the largest shard's count (a
    multiple of 128) with rows at the local discard slot. The arrays are
    grandtpu's, element for element."""
    rows_local: np.ndarray   # int32 [S, E_max] local row (pad: rows_per)
    cols: np.ndarray         # int32 [S, E_max] global col (pad: 0)
    vals: np.ndarray         # float32 [S, E_max] raw values (pad: 0)
    dinv: np.ndarray         # float32 [S, rows_per] 1/max(deg, 1e-12)
    num_nodes: int
    rows_per_shard: int

    @property
    def num_shards(self) -> int:
        return self.rows_local.shape[0]

    @staticmethod
    def build(adj: sp.spmatrix, num_shards: int) -> "ShardedGraph":
        adj = adj.tocsr()
        n = adj.shape[0]
        rows_per = -(-n // num_shards)
        deg = np.asarray(adj.sum(1)).flatten()
        dinv = (1.0 / np.maximum(deg, 1e-12)).astype(np.float32)
        dinv = np.concatenate(
            [dinv, np.zeros(rows_per * num_shards - n, np.float32)])
        coo = adj.tocoo()
        shard_of = coo.row // rows_per
        per_shard = []
        for s in range(num_shards):
            m = shard_of == s
            per_shard.append((coo.row[m] - s * rows_per, coo.col[m],
                              coo.data[m].astype(np.float32)))
        e_max = max(max(r.shape[0] for r, _, _ in per_shard), 1)
        e_max = -(-e_max // 128) * 128
        rows_l = np.full((num_shards, e_max), rows_per, np.int32)
        cols = np.zeros((num_shards, e_max), np.int32)
        vals = np.zeros((num_shards, e_max), np.float32)
        for s, (r, c, v) in enumerate(per_shard):
            rows_l[s, : r.shape[0]] = r
            cols[s, : c.shape[0]] = c
            vals[s, : v.shape[0]] = v
        return ShardedGraph(rows_l, cols, vals,
                            dinv.reshape(num_shards, rows_per), n, rows_per)


class ShardedPropagator(AxisPropagator):
    """Row-partitioned propagation with each shard's rows applied by K2-seg
    (grandtpu's scatter variant): the shards' COO and ``D^-1`` go to their
    devices once, at construction. Call it with ``x`` [n, F] and
    ``mode``, ``order``, ``alpha``, ``plain``."""

    def _build(self):
        g, mesh = self.g, self.mesh
        n_pad = g.rows_per_shard * g.num_shards
        rows = g.rows_per_shard
        self.coo = [PaddedCSR(*(torch.as_tensor(a[s], device=d)
                                for a in (g.rows_local, g.cols, g.vals)),
                              num_nodes=rows, chunk=128, num_cols=n_pad,
                              row_counts=np.bincount(g.rows_local[s],
                                                     minlength=rows + 1))
                    for s, d in zip(mesh.shards, mesh.devices)]
        self.dinv = [torch.as_tensor(g.dinv[s], device=d)
                     for s, d in zip(mesh.shards, mesh.devices)]

    def _run(self, x, *, mode: str = "ppr", order: int = 10,
             alpha: float = 0.2, plain: bool = False) -> torch.Tensor:
        ops = _PLAIN if plain else _KERNELS
        xs = place(self.mesh, self.g.num_nodes, self.g.rows_per_shard, x)

        def hop(cur_in, cur_out, acc, scale, accumulate):
            full = self.mesh.all_gather(cur_in)
            accs = acc if accumulate else [None] * len(cur_in)
            for s, coo in enumerate(self.coo):
                # (dinv * (A_s x)) * scale, then the update, in grandtpu's
                # order: one launch
                ops.segment(coo, full[s], cur_out[s], accs[s], scale,
                            accumulate, row_scale=self.dinv[s])

        outs = _iterate(xs, hop, mode, order, alpha)
        return self.mesh.gather_rows(outs)[: self.g.num_nodes]


def sharded_propagate(mesh: Mesh, g: ShardedGraph, x, *, mode: str = "ppr",
                      order: int = 10, alpha: float = 0.2,
                      axis: str = "data") -> torch.Tensor:
    """One-shot convenience wrapper over :class:`ShardedPropagator`."""
    return ShardedPropagator(mesh, g, axis)(x, mode=mode, order=order,
                                            alpha=alpha)


_DIST_PRECISIONS = ("f32", "bf16", "int8", "int8cast")


def _check_dist_precision(precision: str) -> str:
    """grandtpu's validation of a sharded propagator's precision: 'int8mxu'
    (the single-device spelling) is 'int8', which already runs K2-q8mxu on
    row-constant operators; anything else outside the set raises."""
    if precision == "int8mxu":
        return "int8"
    if precision not in _DIST_PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; sharded propagators accept "
            f"{_DIST_PRECISIONS} (or 'int8mxu' as an alias for 'int8')")
    return precision


def _shard_csrs(shard, local_row, cols, vals, num_shards: int,
                rows_per: int) -> list:
    """Per shard, the CSR (indptr int32 [rows_per + 1], indices int32,
    values f32) of edges given sorted by (shard, local row)."""
    counts = np.bincount(shard * rows_per + local_row,
                         minlength=num_shards * rows_per)
    bounds = np.searchsorted(shard, np.arange(num_shards + 1))
    out = []
    for s in range(num_shards):
        indptr = np.zeros(rows_per + 1, np.int64)
        np.cumsum(counts[s * rows_per: (s + 1) * rows_per], out=indptr[1:])
        part = slice(bounds[s], bounds[s + 1])
        out.append((indptr.astype(np.int32), cols[part].astype(np.int32),
                    vals[part].astype(np.float32)))
    return out


def _row_val_blocks(vals, cols, adj, num_shards: int, rows_per: int):
    """grandtpu's row values of the folded D^-1 A (its edges in CSR order),
    zero-padded to [S, rows_per]; None if a row is not constant."""
    rv = row_values_if_constant(sp.csr_matrix(
        (vals, cols.astype(np.int32), adj.indptr), shape=adj.shape))
    if rv is None:
        return None
    rv = np.pad(rv.astype(np.float32), (0, rows_per * num_shards - rv.size))
    return rv.reshape(num_shards, rows_per)


def _to_ops(csrs, devices, num_rows: int, num_cols: int) -> list:
    return [CSROperator(*(torch.as_tensor(a, device=d) for a in csr),
                        num_rows=num_rows, num_cols=num_cols)
            for csr, d in zip(csrs, devices)]


@dataclasses.dataclass(frozen=True)
class BlockShardedGraph:
    """Row-partitioned D^-1 A: each shard's rows as a CSR over global
    columns, D^-1 folded in as grandtpu folds it, plus the row values when
    every row's values are equal. ``rows_per_shard`` is grandtpu's
    (``ceil(n / S)`` rounded up to a multiple of ``rows_per_block``)."""
    csrs: list                # per shard (indptr, indices, values)
    num_nodes: int
    rows_per_shard: int
    rows_per_block: int
    row_val: np.ndarray | None = None   # float32 [S, rows_per] or None

    @property
    def num_shards(self) -> int:
        return len(self.csrs)

    @staticmethod
    def build(adj: sp.spmatrix, num_shards: int, rows_per_block: int = 512,
              pad_multiple: int = 512) -> "BlockShardedGraph":
        """``pad_multiple`` (grandtpu's TPU block padding) is accepted and
        ignored."""
        del pad_multiple
        adj = adj.tocsr()
        n = adj.shape[0]
        deg = np.asarray(adj.sum(1)).flatten()
        dinv = (1.0 / np.maximum(deg, 1e-12)).astype(np.float32)
        rows_per = -(-n // num_shards)
        rows_per = -(-rows_per // rows_per_block) * rows_per_block
        coo = adj.tocoo()
        rows = coo.row.astype(np.int64)
        cols = coo.col.astype(np.int32)
        vals = (coo.data * dinv[rows]).astype(np.float32)
        shard = rows // rows_per
        csrs = _shard_csrs(shard, rows - shard * rows_per, cols, vals,
                           num_shards, rows_per)
        return BlockShardedGraph(
            csrs, n, rows_per, rows_per_block,
            _row_val_blocks(vals, cols, adj, num_shards, rows_per))


class BlockShardedPropagator(AxisPropagator):
    """Row-partitioned propagation on the K2 family. precision: 'f32' |
    'bf16' | 'int8' | 'int8cast' ('int8mxu' = 'int8'); the int8 forms
    quantize each shard's block with the global per-column scale BEFORE the
    all_gather, which then moves a quarter of the f32 bytes."""

    def _build(self):
        g, mesh = self.g, self.mesh
        self.ops = _to_ops([g.csrs[s] for s in mesh.shards], mesh.devices,
                           g.rows_per_shard, g.rows_per_shard * g.num_shards)
        self.row_val = (None if g.row_val is None else
                        [torch.as_tensor(g.row_val[s], device=d)
                         for s, d in zip(mesh.shards, mesh.devices)])

    def _run(self, x, *, mode: str = "ppr", order: int = 10,
             alpha: float = 0.2, precision: str = "f32",
             plain: bool = False) -> torch.Tensor:
        precision = _check_dist_precision(precision)
        k, mesh = (_PLAIN if plain else _KERNELS), self.mesh
        use_mxu = precision == "int8" and self.row_val is not None

        # the int8 hops' column maxima: per shard a pair of [F] buffers,
        # each hop's raised by every shard's hop and zeroed by the quantize
        # of the hop before it
        pairs = None
        if precision in ("int8", "int8cast"):
            pairs = [torch.zeros((2, x.shape[1]), device=d)
                     for d in mesh.devices]
        hops = iter(range(order))

        def hop(cur_in, cur_out, acc, scale, accumulate):
            accs = acc if accumulate else [None] * len(cur_in)
            if pairs is not None:
                t = next(hops)
                if t == 0:
                    amax = mesh.pmax([k.absmax(c) for c in cur_in])
                else:
                    amax = mesh.pmax([p[(t - 1) % 2] for p in pairs])
                raise_ = ([p[t % 2] for p in pairs] if t + 1 < order
                          else [None] * len(pairs))
                qs = [k.quantize(c, a, r)
                      for c, a, r in zip(cur_in, amax, raise_)]
                full = mesh.all_gather([q for q, _ in qs])
                for s, op in enumerate(self.ops):
                    if use_mxu:
                        k.q8mxu(op, full[s], qs[s][1], self.row_val[s],
                                cur_out[s], accs[s], scale, accumulate,
                                raise_[s])
                    else:
                        k.q8(op, full[s], qs[s][1], cur_out[s], accs[s],
                             scale, accumulate, raise_[s])
                return
            step = k.k2 if precision == "f32" else k.k2_bf16
            full = mesh.all_gather(cur_in)
            for s, op in enumerate(self.ops):
                step(op, full[s], cur_out[s], accs[s], scale, accumulate)

        xs = place(mesh, self.g.num_nodes, self.g.rows_per_shard, x)
        outs = _iterate(xs, hop, mode, order, alpha)
        return mesh.gather_rows(outs)[: self.g.num_nodes]


def default_halo_threshold(mesh: Mesh) -> float:
    """grandtpu's default ``halo_threshold`` (``spmm_shard.py:450``): 0.5 on
    a mesh over processes (the halo exchange where it moves less than half
    the rows), 0.0 on one process (the all_gather variant, measured faster
    on shared-memory fabrics)."""
    return 0.5 if mesh.multiprocess else 0.0


def dist_exact_propagator(mesh: Mesh, adj_sl: sp.spmatrix, num_features: int,
                          *, axis: str = "data",
                          halo_threshold: float | None = None,
                          precision: str = "f32"):
    """The propagator :func:`dist_exact_propagate` builds for [n,
    ``num_features``] features, and the precision to call it with."""
    from grandtpu_torch.dist.halo import (HaloPropagator, HaloShardedGraph,
                                          estimate_halo_compression)

    mesh.along(axis)                      # an unknown axis raises
    if precision == "bf16_carry":
        # the sharded carries are already split over the mesh: bf16 terms
        # on f32 carries
        precision = "bf16"
    if precision != "auto":
        precision = _check_dist_precision(precision)
    if halo_threshold is None:
        halo_threshold = default_halo_threshold(mesh)
    if precision == "auto":
        # sized on the global [n, F] carry, as grandtpu does
        precision = choose_fast_precision(adj_sl.shape[0], num_features,
                                          max_degree=_max_row_nnz(adj_sl))
    num_shards = int(mesh.shape[axis])
    if num_shards == 1:
        return exact_propagator(adj_sl, num_features, precision=precision,
                                device=mesh.devices[0])
    if estimate_halo_compression(adj_sl, num_shards) < halo_threshold:
        hg = HaloShardedGraph.build(adj_sl, num_shards=num_shards)
        return HaloPropagator(mesh, hg, axis), precision
    g = BlockShardedGraph.build(adj_sl, num_shards=num_shards)
    return BlockShardedPropagator(mesh, g, axis), precision


def dist_exact_propagate(mesh: Mesh, adj_sl: sp.spmatrix, features, *,
                         mode: str = "ppr", order: int = 10,
                         alpha: float = 0.2, axis: str = "data",
                         halo_threshold: float | None = None,
                         precision: str = "f32") -> torch.Tensor:
    """Row-partitioned full-graph exact propagation, dispatched as in
    grandtpu: 'bf16_carry' runs as 'bf16'; 'auto' resolves on the global
    [n, F]; one shard goes to :func:`exact_propagate`'s propagator; the
    halo exchange when ``estimate_halo_compression < halo_threshold``
    (default :func:`default_halo_threshold`: 0.5 on a mesh over
    processes, 0.0 on one process, so never there unless a threshold is
    passed), else the all_gather variant. Returns [n, F] on the first
    device of this process's shards, on every process."""
    prop, precision = dist_exact_propagator(
        mesh, adj_sl, int(np.shape(features)[1]), axis=axis,
        halo_threshold=halo_threshold, precision=precision)
    return prop(features, mode=mode, order=order, alpha=alpha,
                precision=precision)
