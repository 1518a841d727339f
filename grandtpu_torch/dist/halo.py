"""Halo-exchange row-partitioned propagation (port of
``grandtpu/dist/halo.py``, D1's halo variant) and its two kernels.

Each shard's edges split into a diagonal set (columns it owns, read from
its own block) and a halo set (columns of other shards). At build time,
for every (owner, receiver) pair, the owner's rows the receiver needs
become a padded index list ``send_idx`` [S(owner), S(receiver), C_max];
the halo edges' columns are remapped into the receive buffer
[S * C_max, F]. A hop then runs, per shard:

1. :func:`halo_pack` (``csrc/halo.cu``): gather the send rows, quantized
   with the global per-column scale for the int8 forms (each shard's
   :func:`~grandtpu_torch.sparse.spmm.column_absmax`, then the mesh's max),
   through each owner's :class:`SendPlan` (each distinct row read and
   quantized once), which the propagator builds once from ``send_idx``;
2. ``Mesh.all_to_all``: each shard receives its rows from every owner;
3. :func:`halo_hop` (``csrc/halo.cu``): ``h = h_d + h_h``, the exact f32
   diagonal sum plus the halo sum (f32; int8 with bf16 terms; or int8
   with exact int32 sums times the row value where D^-1 A's rows are
   constant), then the power-iteration update.

As in grandtpu, precision 'bf16' rounds nothing here: only int8 sources
take another form (``halo.py:285-295``). The exchange moves ``S * C_max``
rows a shard instead of all of them; :func:`estimate_halo_compression`
gives that ratio without a build.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.dist.spmm_shard import (_KERNELS, _PLAIN,
                                            AxisPropagator,
                                            _check_dist_precision,
                                            _iterate, _row_val_blocks,
                                            _shard_csrs, _to_ops, place)
from grandtpu_torch.ops._build import check, load_kernels
from grandtpu_torch.sparse.spmm import (BF16, CSROperator, _epilogue_plain,
                                        _row_sums, quantize_with_amax_plain)

_FORMS = {"f32": 0, "cast": 1, "exact": 2}


def _form(recv: torch.Tensor, row_val) -> str:
    if recv.dtype != torch.int8:
        return "f32"
    return "cast" if row_val is None else "exact"


SLOTS_PER_ITEM = 32   # a send plan item's slots at most


@dataclasses.dataclass(frozen=True)
class SendPlan:
    """:func:`halo_pack`'s plan of one owner's ``send_idx`` [m]: the
    distinct source rows in ascending order, each with the slots of the
    send buffer it goes to (``dst``, grouped by source row, ascending
    within one). A row with more than :data:`SLOTS_PER_ITEM` slots (row 0,
    which every padding slot copies) is cut into items of at most that
    many, so one item stays one warp's work. ``item_src`` int32 [I],
    ``item_ptr`` int32 [I + 1] into ``dst`` int32 [m]."""
    item_src: torch.Tensor
    item_ptr: torch.Tensor
    dst: torch.Tensor

    @staticmethod
    def build(send_idx: torch.Tensor) -> "SendPlan":
        """The plan of ``send_idx`` [m], on its device."""
        src, dst = torch.sort(send_idx.long(), stable=True)
        m, dev = src.numel(), src.device
        first = torch.ones(m, dtype=torch.bool, device=dev)
        first[1:] = src[1:] != src[:-1]
        run_start = torch.nonzero(first).flatten()
        pos = (torch.arange(m, device=dev)
               - run_start[torch.cumsum(first, 0) - 1])
        starts = torch.nonzero(pos % SLOTS_PER_ITEM == 0).flatten()
        item_ptr = torch.cat([starts, starts.new_tensor([m])])
        return SendPlan(src[starts].int(), item_ptr.int(), dst.int())


def halo_pack_plain(x_local: torch.Tensor, send_idx: torch.Tensor,
                    amax: torch.Tensor | None = None, plan=None):
    """Plain PyTorch version of :func:`halo_pack` (from ``send_idx``; the
    plan is not read)."""
    rows = x_local[send_idx.long()]
    if amax is None:
        return rows, None
    return quantize_with_amax_plain(rows, amax)


def halo_pack(x_local: torch.Tensor, send_idx: torch.Tensor,
              amax: torch.Tensor | None = None,
              plan: SendPlan | None = None):
    """The send rows ``x_local[send_idx]`` [len(send_idx), F] f32; with the
    global column maxima ``amax`` [F], quantized instead: int8
    ``clamp(round_half_even(x / scale), -127, 127)`` with ``scale = amax /
    127`` (1 for a zero column), in the gather's pass. The kernel walks
    ``plan`` (``SendPlan.build(send_idx)``, built here if not given): each
    distinct row read and quantized once. Returns (send, scale f32 [F] or
    None)."""
    if x_local.device.type == "cpu":
        return halo_pack_plain(x_local, send_idx, amax)
    if x_local.device.type != "cuda":
        raise ValueError(f"unsupported device {x_local.device}")
    if plan is None:
        plan = SendPlan.build(send_idx)
    tensors = [x_local, send_idx, plan.item_src, plan.item_ptr, plan.dst] + (
        [] if amax is None else [amax])
    if any(t.device != x_local.device or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"halo_pack: tensors must be contiguous, on "
                         f"{x_local.device}")
    if (x_local.dtype != torch.float32 or x_local.dim() != 2
            or send_idx.dtype != torch.int32 or send_idx.dim() != 1
            or any(t.dtype != torch.int32 for t in (
                plan.item_src, plan.item_ptr, plan.dst))
            or (amax is not None and (amax.dtype != torch.float32 or
                                      amax.shape != (x_local.shape[1],)))):
        raise TypeError("halo_pack wants f32 x [rows, F], int32 send_idx "
                        "[m] and plan, and f32 amax [F]")
    if (plan.dst.shape != send_idx.shape
            or plan.item_ptr.shape != (plan.item_src.numel() + 1,)):
        raise ValueError("halo_pack: the plan is not one of send_idx")
    nfeat = x_local.shape[1]
    quant = amax is not None
    out = torch.empty((send_idx.shape[0], nfeat), device=x_local.device,
                      dtype=torch.int8 if quant else torch.float32)
    scale = torch.empty(nfeat, device=x_local.device) if quant else None
    if out.numel():
        check(load_kernels().halo_pack(
            x_local.data_ptr(), plan.item_src.data_ptr(),
            plan.item_ptr.data_ptr(), plan.dst.data_ptr(),
            plan.item_src.numel(), amax.data_ptr() if quant else None,
            scale.data_ptr() if quant else None, out.data_ptr(),
            send_idx.shape[0], nfeat, int(quant),
            torch.cuda.current_stream(x_local.device).cuda_stream),
            "halo_pack")
        halo_pack.launches += 1
    return out, scale


def halo_hop_plain(diag: CSROperator, halo: CSROperator,
                   x_local: torch.Tensor, recv: torch.Tensor,
                   cur_out: torch.Tensor, acc: torch.Tensor | None,
                   scale: float, accumulate: bool,
                   col_scale: torch.Tensor | None = None,
                   row_val: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of :func:`halo_hop`: both partial sums in edge
    order, as the kernel adds them."""
    def zeros(dtype=torch.float32):
        return torch.zeros(cur_out.shape, dtype=dtype, device=cur_out.device)

    h_d = _row_sums(diag.indptr, lambda e: x_local[diag.indices[e].long()]
                    * diag.values[e, None], zeros())
    form = _form(recv, row_val)
    if form == "exact":
        isum = _row_sums(halo.indptr,
                         lambda e: recv[halo.indices[e].long()].int(),
                         zeros(torch.int32))
        h_h = isum.float() * row_val[:, None] * col_scale
    elif form == "cast":
        v = halo.values.to(BF16).float()
        h_h = _row_sums(halo.indptr, lambda e: (
            recv[halo.indices[e].long()].float() * v[e, None]).to(BF16)
            .float(), zeros()) * col_scale
    else:
        h_h = _row_sums(halo.indptr, lambda e: recv[halo.indices[e].long()]
                        * halo.values[e, None], zeros())
    _epilogue_plain(h_d + h_h, cur_out, acc, scale, accumulate)


def halo_hop(diag: CSROperator, halo: CSROperator, x_local: torch.Tensor,
             recv: torch.Tensor, cur_out: torch.Tensor,
             acc: torch.Tensor | None, scale: float, accumulate: bool,
             col_scale: torch.Tensor | None = None,
             row_val: torch.Tensor | None = None) -> None:
    """One halo hop of a shard: ``h = diag @ x_local + halo @ recv``, then
    ``cur_out = scale * h`` and ``acc += cur_out`` if ``accumulate``.
    ``recv`` [halo.num_cols, F] is f32, or int8 with ``col_scale`` [F]:
    then the halo terms are ``bf16(q·bf16(v))`` summed in f32, times the
    scale, or, with ``row_val`` [rows], the exact int32 sum times the row
    value and the scale. The diagonal sum is always f32. Carries f32 [rows,
    F]; ``x_local`` [diag.num_cols, F] must not alias ``cur_out``."""
    if x_local.device.type == "cpu":
        halo_hop_plain(diag, halo, x_local, recv, cur_out, acc, scale,
                       accumulate, col_scale, row_val)
        return
    if x_local.device.type != "cuda":
        raise ValueError(f"unsupported device {x_local.device}")
    form = _form(recv, row_val)
    carries = [cur_out] + ([acc] if accumulate else [])
    extra = ([] if form == "f32" else [col_scale]) + (
        [row_val] if form == "exact" else [])
    structure = [diag.indptr, diag.indices, diag.values, halo.indptr,
                 halo.indices, halo.values]
    tensors = carries + extra + structure + [x_local, recv]
    if any(t is None or t.device != x_local.device or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"halo_hop: tensors must be given, contiguous and "
                         f"on {x_local.device}")
    nfeat = x_local.shape[1] if x_local.dim() == 2 else -1
    rows = diag.num_rows
    if (any(t.dtype != torch.float32 for t in carries + extra + [x_local])
            or recv.dtype not in (torch.float32, torch.int8)
            or any(t.dtype != torch.int32 for t in (diag.indptr,
                                                     diag.indices,
                                                     halo.indptr,
                                                     halo.indices))):
        raise TypeError("halo_hop wants f32 carries, x_local, scales and "
                        "row values, f32 or int8 recv, int32 structure")
    if (halo.num_rows != rows
            or tuple(x_local.shape) != (diag.num_cols, nfeat)
            or tuple(recv.shape) != (halo.num_cols, nfeat)
            or any(tuple(t.shape) != (rows, nfeat) for t in carries)
            or (form != "f32" and col_scale.shape != (nfeat,))
            or (form == "exact" and row_val.shape != (rows,))):
        raise ValueError("halo_hop: shapes disagree with the operators")
    if x_local.data_ptr() == cur_out.data_ptr() and x_local.numel():
        raise ValueError("halo_hop: x_local and cur_out must differ")
    if not cur_out.numel():
        return
    check(load_kernels().halo_hop(
        diag.indptr.data_ptr(), diag.indices.data_ptr(),
        diag.values.data_ptr(), x_local.data_ptr(), halo.indptr.data_ptr(),
        halo.indices.data_ptr(), halo.values.data_ptr(), recv.data_ptr(),
        None if form == "f32" else col_scale.data_ptr(),
        row_val.data_ptr() if form == "exact" else None,
        cur_out.data_ptr(), acc.data_ptr() if accumulate else None, rows,
        nfeat, float(scale), int(accumulate), _FORMS[form],
        torch.cuda.current_stream(x_local.device).cuda_stream), "halo_hop")
    halo_hop.launches += 1


halo_pack.launches = 0
halo_hop.launches = 0


def estimate_halo_compression(adj: sp.spmatrix, num_shards: int,
                              rows_per_block: int = 512) -> float:
    """The exchange's volume over the all_gather's, ``S * C_max / n_pad``,
    without building either representation (grandtpu's estimator; equal
    to :attr:`HaloShardedGraph.compression`)."""
    adj = adj.tocsr()
    n = adj.shape[0]
    S = num_shards
    rows_per = -(-n // S)
    rows_per = -(-rows_per // rows_per_block) * rows_per_block
    coo = adj.tocoo()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    d_of = row // rows_per
    s_of = col // rows_per
    halo_m = d_of != s_of
    key = ((d_of[halo_m] * S + s_of[halo_m]) * rows_per
           + (col[halo_m] - s_of[halo_m] * rows_per))
    uniq = np.unique(key)
    counts = np.bincount(uniq // rows_per, minlength=S * S)
    c_max = max(int(counts.max()) if uniq.size else 0, 1)
    return (S * c_max) / (rows_per * S)


@dataclasses.dataclass(frozen=True)
class HaloShardedGraph:
    """Row-partitioned D^-1 A split into a diagonal and a halo CSR per
    shard, both D^-1 folded; ``send_idx``, ``rows_per_shard``,
    ``halo_per_pair`` (C_max) and ``compression`` are grandtpu's."""
    diag: list               # per shard (indptr, indices, values), local cols
    halo: list               # per shard, cols into the [S * C_max] buffer
    send_idx: np.ndarray     # int32 [S(owner), S(receiver), C_max]
    num_nodes: int
    rows_per_shard: int
    rows_per_block: int
    halo_per_pair: int       # C_max
    row_val: np.ndarray | None = None   # float32 [S, rows_per] or None

    @property
    def num_shards(self) -> int:
        return len(self.diag)

    @property
    def compression(self) -> float:
        """The exchange's volume over the all_gather's (< 1: halo moves
        less)."""
        return (self.num_shards * self.halo_per_pair) / (
            self.rows_per_shard * self.num_shards)

    @staticmethod
    def build(adj: sp.spmatrix, num_shards: int,
              rows_per_block: int = 512) -> "HaloShardedGraph":
        adj = adj.tocsr()
        n = adj.shape[0]
        S = num_shards
        rows_per = -(-n // S)
        rows_per = -(-rows_per // rows_per_block) * rows_per_block
        deg = np.asarray(adj.sum(1)).flatten()
        dinv = (1.0 / np.maximum(deg, 1e-12)).astype(np.float32)

        coo = adj.tocoo()   # row-major: filtered subsets stay row-sorted
        row = coo.row.astype(np.int64)
        col = coo.col.astype(np.int64)
        d_of = row // rows_per          # receiver (row owner)
        s_of = col // rows_per          # column owner
        vals = (coo.data * dinv[row]).astype(np.float32)
        local_r = (row - d_of * rows_per).astype(np.int32)
        local_c = (col - s_of * rows_per).astype(np.int32)
        halo_m = d_of != s_of

        # per (receiver d, owner s): the unique local columns needed, all
        # pairs at once through one sorted unique of a composite key
        pair = d_of[halo_m] * S + s_of[halo_m]
        key = pair * rows_per + local_c[halo_m]
        uniq, inv = np.unique(key, return_inverse=True)
        upair = uniq // rows_per
        ulc = (uniq % rows_per).astype(np.int32)
        counts = np.bincount(upair, minlength=S * S)
        c_max = max(int(counts.max()) if uniq.size else 0, 1)
        starts = np.zeros(S * S + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos_in_group = np.arange(uniq.size, dtype=np.int64) - starts[upair]
        send_idx = np.zeros((S, S, c_max), np.int32)
        send_idx[upair % S, upair // S, pos_in_group] = ulc
        # each halo edge's column in the receiver's [S, C_max] buffer
        remapped = s_of[halo_m] * c_max + pos_in_group[inv.reshape(-1)]

        diag_m = ~halo_m
        diag = _shard_csrs(d_of[diag_m], local_r[diag_m], local_c[diag_m],
                           vals[diag_m], S, rows_per)
        halo = _shard_csrs(d_of[halo_m], local_r[halo_m], remapped,
                           vals[halo_m], S, rows_per)
        return HaloShardedGraph(
            diag, halo, send_idx, n, rows_per, rows_per_block, c_max,
            _row_val_blocks(vals, col, adj, S, rows_per))


class HaloPropagator(AxisPropagator):
    """Row-partitioned propagation with the halo exchange. precision:
    'f32' | 'bf16' (runs as f32, as in grandtpu) | 'int8' | 'int8cast'
    ('int8mxu' = 'int8'); the int8 forms quantize the exchange only, with
    the global per-column scale: the diagonal sum stays exact f32."""

    def _build(self):
        g, mesh = self.g, self.mesh
        S, rows_per, c_max = g.num_shards, g.rows_per_shard, g.halo_per_pair
        local = list(zip(mesh.shards, mesh.devices))
        self.diag = _to_ops([g.diag[s] for s in mesh.shards], mesh.devices,
                            rows_per, rows_per)
        self.halo = _to_ops([g.halo[s] for s in mesh.shards], mesh.devices,
                            rows_per, S * c_max)
        self.send_idx = [torch.as_tensor(g.send_idx[s].reshape(-1), device=d)
                         for s, d in local]
        self.plans = [SendPlan.build(idx) for idx in self.send_idx]
        self.row_val = (None if g.row_val is None else
                        [torch.as_tensor(g.row_val[s], device=d)
                         for s, d in local])

    def _run(self, x, *, mode: str = "ppr", order: int = 10,
             alpha: float = 0.2, precision: str = "f32",
             plain: bool = False) -> torch.Tensor:
        precision = _check_dist_precision(precision)
        k, mesh, g = (_PLAIN if plain else _KERNELS), self.mesh, self.g
        pack, hop_fn = ((halo_pack_plain, halo_hop_plain) if plain
                        else (halo_pack, halo_hop))
        quant = precision in ("int8", "int8cast")
        use_mxu = precision == "int8" and self.row_val is not None
        S, c_max = g.num_shards, g.halo_per_pair

        def hop(cur_in, cur_out, acc, scale, accumulate):
            if quant:
                amax = mesh.pmax([k.absmax(c) for c in cur_in])
            else:
                amax = [None] * len(cur_in)
            packs = [pack(c, idx, a, plan) for c, idx, a, plan in
                     zip(cur_in, self.send_idx, amax, self.plans)]
            recv = mesh.all_to_all([p.view(S, c_max, -1) for p, _ in packs])
            for s in range(len(cur_in)):
                hop_fn(self.diag[s], self.halo[s], cur_in[s],
                       recv[s].view(S * c_max, -1), cur_out[s],
                       acc[s] if accumulate else None, scale, accumulate,
                       packs[s][1], self.row_val[s] if use_mxu else None)

        xs = place(mesh, g.num_nodes, g.rows_per_shard, x)
        outs = _iterate(xs, hop, mode, order, alpha)
        return mesh.gather_rows(outs)[: g.num_nodes]
