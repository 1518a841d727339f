"""Sparse-residue GFPush (P2), the port of ``grandtpu/ppr/bucket_push.py``,
reached by ``gfpush(backend="bucket")``: memory O(frontier), not O(B*n).

Per source row only the live residues are kept, as a :class:`Frontier`.
The hop semantics are grandtpu's (reference ``graph.h:53-131``): every
residue adds ``coef[i] * r`` to its node's reserve; a residue on a dangling
node teleports back to the source; one with ``r >= rmax * deg`` sends
``r / deg`` to each neighbour; the rest are dropped. Residues and reserves
are 62-bit fixed point (1.0 = 2^62, int64 storage, every value <= 1): the
rmax test is ``q >= ceil(rmax * deg * 2^62)``, the pushed value ``q // deg``,
a reserve contribution ``trunc(coef * q)`` (in float64), and every sum an
exact integer sum, so the push gives the same output on every run and in
any summation order. grandtpu pushes in f32, so the two agree to the
pruning granularity (a borderline rmax decision can flip), not bit for bit.

On CUDA a hop is two kernels (``csrc/push_bucket.cu``): :func:`bucket_expand`
sums the pushed values of each source in a hash table sized from the
expansion slots the compaction counted (one host read a hop), and
:func:`bucket_compact` turns the table into the next frontier. The reserve
log (each hop's frontier) is merged into one table per source by the same
two kernels, then :func:`~grandtpu_torch.ppr.push_topk.push_topk` keeps k.
On CPU tensors :func:`push_hop` and :func:`reserve_topk` run their plain
versions, which sort and sum with PyTorch's integer ops and give the same
integers. grandtpu's TPU layout (shape buckets, replay plans, ``window``-wide
edge blocks) is not carried over: ``window`` is accepted and unused. The
block back-off is grandtpu's: a hop that needs more than ``slot_limit``
expansion slots, or a CUDA out-of-memory error, halves the block (down to
``min_block``) with grandtpu's warning, and the push stays on the device.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from grandtpu_torch.device import resolve_device
from grandtpu_torch.ops._build import check, load_kernels
from grandtpu_torch.ppr.push_topk import push_topk, push_topk_plain, row_offsets

ONE = 1 << 62            # 1.0 in the push's fixed point


@dataclasses.dataclass
class Frontier:
    """The live residues of a block of B sources: source b's entries are
    ``ids[off[b]:off[b] + cnt[b]]`` (int32 nodes) and ``q[...]`` (int64,
    Q62, > 0); ``exp[b]`` is the count of expansion slots its next hop
    needs (``deg(u)`` for each pushing entry, 1 for each dangling one)."""
    off: torch.Tensor
    cnt: torch.Tensor
    ids: torch.Tensor
    q: torch.Tensor
    exp: torch.Tensor


class BucketPushGraph:
    """Device-resident push tables for one (graph, rmax) pair: CSR indptr
    and indices (int32), degrees and the Q62 rmax thresholds (int64).
    ``window`` (grandtpu's edge-block width) is accepted and unused."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, rmax: float,
                 window: int = 8, device="cuda"):
        self.device = resolve_device(device)
        indptr = np.asarray(indptr, np.int32)
        self.n = indptr.shape[0] - 1
        deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
        # ceil(rmax * deg * 2^62); anything above 1.0 never pushes
        thr = np.minimum(np.ceil(np.float64(rmax) * deg * float(ONE)),
                         1.5 * ONE).astype(np.int64)
        self.indptr = torch.as_tensor(indptr, device=self.device)
        self.indices = torch.as_tensor(np.asarray(indices, np.int32),
                                       device=self.device)
        self.deg = torch.as_tensor(deg, device=self.device)
        self.thr = torch.as_tensor(thr, device=self.device)

    def slots(self, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Expansion slots of each entry (``Frontier.exp``'s terms)."""
        d = self.deg[ids.long()]
        return torch.where(d == 0, 1, torch.where(q >= self.thr[ids.long()],
                                                  d, 0))


def initial_frontier(g: BucketPushGraph, src: torch.Tensor) -> Frontier:
    """Each source's residue 1.0 at itself."""
    b = src.shape[0]
    ar = torch.arange(b, device=src.device)
    q = torch.full((b,), ONE, dtype=torch.int64, device=src.device)
    return Frontier(off=ar, cnt=torch.ones_like(ar), ids=src, q=q,
                    exp=g.slots(src, q))


def _entries(fr: Frontier):
    """Flat positions of every entry and the row (source) of each."""
    rows = torch.repeat_interleave(
        torch.arange(fr.cnt.numel(), device=fr.cnt.device), fr.cnt)
    start = row_offsets(fr.cnt)[:-1]
    pos = fr.off[rows] + torch.arange(rows.numel(), device=rows.device) \
        - start[rows]
    return pos, rows


def _sum_by_key(g: BucketPushGraph, rows, nodes, vals, num_rows: int):
    """Exact sums of ``vals`` per (row, node), sorted by row then node:
    (rows, ids int32, sums int64, counts per row)."""
    key, inv = torch.unique(rows * g.n + nodes, return_inverse=True)
    sums = torch.zeros(key.numel(), dtype=torch.int64, device=key.device)
    sums.index_add_(0, inv, vals)
    rows = key // g.n
    return (rows, (key % g.n).int(), sums,
            torch.bincount(rows, minlength=num_rows))


def push_hop_plain(g: BucketPushGraph, fr: Frontier,
                   src: torch.Tensor) -> Frontier:
    """Plain PyTorch version of :func:`push_hop`."""
    pos, rows = _entries(fr)
    u, q = fr.ids[pos].long(), fr.q[pos]
    d = g.deg[u]
    dangling = d == 0
    push = ~dangling & (q >= g.thr[u])
    p = q[push] // d[push]
    live = p > 0
    u, rows_p, p, d = u[push][live], rows[push][live], p[live], d[push][live]
    # neighbour j of entry e: indices[indptr[u_e] + j]
    first = torch.repeat_interleave(row_offsets(d)[:-1], d)
    edge = (torch.repeat_interleave(g.indptr[u].long(), d)
            + torch.arange(first.numel(), device=first.device) - first)
    nodes = torch.cat([g.indices[edge].long(), src[rows[dangling]].long()])
    owner = torch.cat([torch.repeat_interleave(rows_p, d), rows[dangling]])
    vals = torch.cat([torch.repeat_interleave(p, d), q[dangling]])
    owner, ids, sums, cnt = _sum_by_key(g, owner, nodes, vals, src.shape[0])
    exp = torch.zeros_like(cnt).index_add_(0, owner, g.slots(ids, sums))
    return Frontier(off=row_offsets(cnt)[:-1], cnt=cnt, ids=ids, q=sums,
                    exp=exp)


def bucket_expand(fr: Frontier, src: torch.Tensor, g: BucketPushGraph,
                  t_off: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                  merge: bool, coef: float = 0.0) -> None:
    """Launch ``bucket_expand`` (CUDA tensors only): the pushes of ``fr``
    (or, with ``merge``, its reserve contributions ``trunc(coef * q)``)
    summed into the hash tables ``keys``/``vals`` at offsets ``t_off``."""
    rc = load_kernels().bucket_expand(
        fr.ids.data_ptr(), fr.q.data_ptr(), fr.off.data_ptr(),
        fr.cnt.data_ptr(), src.data_ptr(), g.indptr.data_ptr(),
        g.indices.data_ptr(), g.thr.data_ptr(), t_off.data_ptr(),
        keys.data_ptr(), vals.data_ptr(), src.shape[0], int(merge),
        float(coef), torch.cuda.current_stream(src.device).cuda_stream)
    check(rc, "bucket_expand")
    bucket_expand.launches += 1


def bucket_compact(g: BucketPushGraph, t_off: torch.Tensor,
                   keys: torch.Tensor, vals: torch.Tensor, final: bool):
    """Launch ``bucket_compact`` (CUDA tensors only): the tables as the
    next :class:`Frontier`, or with ``final`` their values as f32."""
    b = t_off.numel() - 1
    dev = keys.device
    if final:
        out_f = torch.empty(keys.numel(), dtype=torch.float32, device=dev)
        ids = q = cnt = exp = None
    else:
        out_f = None
        ids = torch.empty_like(keys)
        q = torch.empty_like(vals)
        cnt = torch.empty(b, dtype=torch.int64, device=dev)
        exp = torch.empty(b, dtype=torch.int64, device=dev)
    ptr = [None if t is None else t.data_ptr()
           for t in (ids, q, cnt, exp, out_f)]
    rc = load_kernels().bucket_compact(
        keys.data_ptr(), vals.data_ptr(), t_off.data_ptr(),
        g.indptr.data_ptr(), g.thr.data_ptr(), *ptr, b, int(final),
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "bucket_compact")
    bucket_compact.launches += 1
    if final:
        return out_f
    return Frontier(off=t_off[:-1], cnt=cnt, ids=ids, q=q, exp=exp)


bucket_expand.launches = 0
bucket_compact.launches = 0


def _tables(caps: torch.Tensor, total: int):
    """Empty hash tables of ``caps`` [B] slots each, ``total`` in all."""
    t_off = row_offsets(caps)
    keys = torch.full((total,), -1, dtype=torch.int32, device=caps.device)
    vals = torch.zeros(total, dtype=torch.int64, device=caps.device)
    return t_off, keys, vals


def _check_cuda(g: BucketPushGraph, tensors) -> None:
    if any(t.device != g.indptr.device for t in tensors):
        raise ValueError(f"bucket push: all tensors must be on "
                         f"{g.indptr.device}")


def push_hop(g: BucketPushGraph, fr: Frontier, src: torch.Tensor,
             slots: int) -> Frontier:
    """One hop from ``fr`` (sources ``src`` int32 [B]); ``slots`` is
    ``fr.exp.sum()``, which the caller has read. The next frontier's
    entries are in no particular order within a row."""
    if fr.ids.device.type == "cpu":
        return push_hop_plain(g, fr, src)
    _check_cuda(g, [fr.ids, fr.q, fr.off, fr.cnt, fr.exp, src])
    t_off, keys, vals = _tables(2 * fr.exp, 2 * slots)
    bucket_expand(fr, src, g, t_off, keys, vals, merge=False)
    return bucket_compact(g, t_off, keys, vals, final=False)


def reserve_topk_plain(g: BucketPushGraph, logs: list, k: int):
    """Plain PyTorch version of :func:`reserve_topk`."""
    parts = []
    for fr, coef in logs:
        pos, rows = _entries(fr)
        c = (fr.q[pos].double() * coef).long()
        keep = c > 0
        parts.append((rows[keep], fr.ids[pos][keep].long(), c[keep]))
    rows, ids, sums, cnt = _sum_by_key(
        g, *(torch.cat(p) for p in zip(*parts)), logs[0][0].cnt.numel())
    vals = (sums.double() / ONE).float()
    return push_topk_plain(ids, vals, row_offsets(cnt), k)


def reserve_topk(g: BucketPushGraph, logs: list, k: int):
    """Merge the reserve log ``[(frontier of hop i, coef[i]), ...]`` into
    each source's reserves, ``sum_i trunc(coef[i] * q_i)`` per node, and
    keep the top k: (cols int32 [B, k], vals f32 [B, k]) on the device."""
    fr0 = logs[0][0]
    if fr0.ids.device.type == "cpu":
        return reserve_topk_plain(g, logs, k)
    caps = 2 * sum(fr.cnt for fr, _ in logs)
    t_off, keys, vals = _tables(caps, int(caps.sum()))
    for fr, coef in logs:
        # the first frontier's ids are the sources (unread when merging)
        bucket_expand(fr, fr0.ids, g, t_off, keys, vals, merge=True,
                      coef=coef)
    out_f = bucket_compact(g, t_off, keys, vals, final=True)
    return push_topk(keys, out_f, t_off, k)


def push_block(g: BucketPushGraph, src: torch.Tensor, coef: np.ndarray,
               k: int, slot_limit: int = 1 << 62, plain: bool = False):
    """P2 for the sources ``src`` (int32 [B] on ``g.device``): (cols int32
    [B, k], vals f32 [B, k]) on the device. Raises MemoryError when a hop
    needs more than ``slot_limit`` expansion slots. ``plain`` runs the plain
    versions on any device."""
    hop = (lambda g_, fr, s, _: push_hop_plain(g_, fr, s)) if plain \
        else push_hop
    reserve = reserve_topk_plain if plain else reserve_topk
    n_hops = coef.shape[0] - 1
    fr = initial_frontier(g, src)
    logs = []
    for i in range(n_hops):
        logs.append((fr, float(coef[i])))
        slots = int(fr.exp.sum())          # the hop's one host read
        if slots == 0:                     # nothing pushes: no next frontier
            fr = None
            break
        if slots > slot_limit:
            raise MemoryError(f"gfpush_bucketed: a hop needs {slots} slots "
                              f"(> {slot_limit}); use a smaller block")
        fr = hop(g, fr, src, slots)
    if fr is not None:
        logs.append((fr, float(coef[n_hops])))
    return reserve(g, logs, k)


def gfpush_bucketed(indptr: np.ndarray, indices: np.ndarray,
                    sources: np.ndarray, coef: np.ndarray, rmax: float,
                    k: int, *, block: int = 1024, window: int = 8,
                    slot_limit: int = 1 << 27, min_block: int = 64,
                    graph: BucketPushGraph | None = None, device="cuda"):
    """Run the sparse-residue push over all sources in blocks of ``block``
    on ``device`` (``graph.device`` when a graph is given). Returns numpy
    (cols int32 [n_src, k], vals float32 [n_src, k]), each row by
    descending reserve value, zero-padded, as grandtpu's."""
    if graph is None:
        graph = BucketPushGraph(indptr, indices, rmax, window=window,
                                device=device)
    try:
        return _run(graph, sources, coef, k, block, slot_limit)
    except (MemoryError, torch.cuda.OutOfMemoryError) as e:
        if block // 2 < min_block:
            raise
        warnings.warn(f"gfpush_bucketed: block={block} exceeded memory "
                      f"({type(e).__name__}); retrying at block={block // 2}")
        return gfpush_bucketed(indptr, indices, sources, coef, rmax, k,
                               block=block // 2, window=window,
                               slot_limit=slot_limit, min_block=min_block,
                               graph=graph)


def _run(g: BucketPushGraph, sources, coef, k: int, block: int,
         slot_limit: int):
    sources = np.asarray(sources, np.int32)
    coef = np.asarray(coef, np.float32)
    n_src = sources.shape[0]
    out_cols = np.zeros((n_src, k), np.int32)
    out_vals = np.zeros((n_src, k), np.float32)
    for start in range(0, n_src, block):
        sl = slice(start, min(start + block, n_src))
        src = torch.as_tensor(sources[sl], device=g.device)
        cols, vals = push_block(g, src, coef, k, slot_limit)
        out_cols[sl] = cols.cpu().numpy()
        out_vals[sl] = vals.cpu().numpy()
    return out_cols, out_vals
