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

On CUDA a hop is one kernel (``csrc/push_bucket.cu``): :func:`bucket_hop`
gives each source one CTA that expands its frontier into a hash table
(in shared memory when it fits, else in a global region that
:func:`table_layout` places on the device from the expansion slots, one
host read a hop) and compacts the table into the next frontier. The
shared table's size is the kernel's (``SMEM_SLOTS`` here); a launch whose
layout gives a source too little room raises instead of losing sums.
:func:`bucket_reserve` merges the whole reserve log (each hop's frontier)
into one table per source in one launch, then
:func:`~grandtpu_torch.ppr.push_topk.push_topk` keeps k. On CPU tensors
:func:`push_hop` and :func:`reserve_topk` run their plain versions, which
sort and sum with PyTorch's integer ops and give the same integers.
grandtpu's TPU layout (shape buckets, replay plans, ``window``-wide edge
blocks) is not carried over: ``window`` is accepted and unused. The block
back-off is grandtpu's: a hop that needs more than ``slot_limit``
expansion slots, or a CUDA out-of-memory error, halves the block (down to
``min_block``) with grandtpu's warning, and the push stays on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings

import numpy as np
import torch

from grandtpu_torch.device import resolve_device
from grandtpu_torch.ops._build import check, load_kernels
from grandtpu_torch.ppr.push_topk import push_topk, push_topk_plain, row_offsets

ONE = 1 << 62            # 1.0 in the push's fixed point
SMEM_SLOTS = 8192        # push_bucket.cu's kSmemSlots: 96 KB, two CTAs an SM


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
        self.rec = node_records(self.indptr, self.thr)

    def slots(self, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Expansion slots of each entry (``Frontier.exp``'s terms)."""
        d = self.deg[ids.long()]
        return torch.where(d == 0, 1, torch.where(q >= self.thr[ids.long()],
                                                  d, 0))


@dataclasses.dataclass
class TableLayout:
    """Where a launch's per-source tables and outputs live: source b writes
    ``out_off[b]:out_off[b + 1]``; its table is in global scratch at
    ``g_off[b]`` when ``g_off[b + 1] > g_off[b]``, else in shared memory.
    ``slots`` is the output entries in all, ``spill`` the global scratch
    slots, ``global_sources`` the count of sources with a global table."""
    out_off: torch.Tensor
    g_off: torch.Tensor
    slots: int
    spill: int
    global_sources: int


def node_records(indptr: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """One 16-byte record a node, int64 [n, 2]: row start (int32) and
    degree (int32) in the first word, the Q62 threshold in the second, so
    that one aligned load reads all three."""
    start = indptr[:-1].long()
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.stack([(deg << 32) | (start & 0xFFFFFFFF), thr], dim=1)


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


def table_layout(n: torch.Tensor) -> TableLayout:
    """Where the tables of a launch over B sources with ``n`` [B] inserts
    each live (``exp`` for a hop, the log's entries for the reserves): a
    source with ``4 * n <= 3 * SMEM_SLOTS`` uses shared memory, any other
    a global region of ``4 * n`` slots, which holds its table of the
    smallest power of two >= ``2 * n``. Output regions hold ``n[b]``
    entries. A few launches and one host read of three numbers."""
    spill = 4 * n > 3 * SMEM_SLOTS
    offs = torch.zeros((3, n.numel() + 1), dtype=torch.int64,
                       device=n.device)
    offs[:, 1:] = torch.stack([n, 4 * n * spill, spill]).cumsum(1)
    slots, spill_slots, spilled = offs[:, -1].tolist()
    return TableLayout(out_off=offs[0], g_off=offs[1], slots=slots,
                       spill=spill_slots, global_sources=spilled)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(layout: TableLayout, dev):
    """The global tables' scratch (filled by the kernel) and the launch's
    error word (zeroed)."""
    return (torch.empty(layout.spill, dtype=torch.int32, device=dev),
            torch.empty(layout.spill, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _check_tables(err: torch.Tensor, name: str) -> None:
    """Raise if the launch set its error word: a source whose layout gave
    its table or output too few slots (bit 1), or a table or output region
    that filled up (bit 2)."""
    code = int(err.item())
    if code:
        raise RuntimeError(f"{name}: a source's table or output region was "
                           f"too small for its inserts (error {code}); the "
                           f"layout does not match the launch")


def bucket_hop(g: BucketPushGraph, fr: Frontier, src: torch.Tensor,
               layout: TableLayout) -> Frontier:
    """Launch ``bucket_hop`` (CUDA tensors only): one hop from ``fr``, its
    tables laid out by ``layout = table_layout(fr.exp)``; the next
    frontier's region b holds ``fr.exp[b]`` entries."""
    dev = src.device
    _check_cuda(g, [fr.ids, fr.q, fr.off, fr.cnt, fr.exp, src,
                    layout.out_off, layout.g_off])
    b = src.shape[0]
    ids = torch.empty(layout.slots, dtype=torch.int32, device=dev)
    q = torch.empty(layout.slots, dtype=torch.int64, device=dev)
    cnt = torch.empty(b, dtype=torch.int64, device=dev)
    exp = torch.empty(b, dtype=torch.int64, device=dev)
    g_keys, g_vals, err = _scratch(layout, dev)
    rc = load_kernels().bucket_hop(
        fr.ids.data_ptr(), fr.q.data_ptr(), fr.off.data_ptr(),
        fr.cnt.data_ptr(), fr.exp.data_ptr(), src.data_ptr(),
        g.rec.data_ptr(), g.indices.data_ptr(), layout.g_off.data_ptr(),
        g_keys.data_ptr(), g_vals.data_ptr(), layout.out_off.data_ptr(),
        ids.data_ptr(), q.data_ptr(), cnt.data_ptr(), exp.data_ptr(),
        err.data_ptr(), b, _stream(src))
    check(rc, "bucket_hop")
    bucket_hop.launches += 1
    _check_tables(err, "bucket_hop")
    bucket_hop.global_sources = layout.global_sources
    return Frontier(off=layout.out_off[:-1], cnt=cnt, ids=ids, q=q, exp=exp)


def bucket_reserve(logs: list, layout: TableLayout, sums: bool = False):
    """Launch ``bucket_reserve`` (CUDA tensors only): the reserve log
    ``[(frontier, coef), ...]`` merged per source, its tables laid out by
    ``layout = reserve_layout(logs)``. Returns (ids int32, sums int64 or
    None, vals f32, cnt [B]): source b's ``cnt[b]`` distinct reserves
    first in its region ``layout.out_off[b]:[b + 1]``, then id -1, 0."""
    fr0 = logs[0][0]
    dev = fr0.ids.device
    if dev.type != "cuda" or any(
            t.device != dev for fr, _ in logs
            for t in (fr.ids, fr.q, fr.off, fr.cnt)):
        raise ValueError(f"bucket_reserve: all tensors must be on one "
                         f"CUDA device, not {dev}")
    b = fr0.cnt.numel()
    table = np.array([[fr.ids.data_ptr(), fr.q.data_ptr(), fr.off.data_ptr(),
                       fr.cnt.data_ptr(), 0] for fr, _ in logs], np.int64)
    table[:, 4] = np.array([c for _, c in logs], np.float64).view(np.int64)
    # pinned, so that the copy does not wait for the stream to drain
    table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    ids = torch.empty(layout.slots, dtype=torch.int32, device=dev)
    out_sums = (torch.empty(layout.slots, dtype=torch.int64, device=dev)
                if sums else None)
    vals = torch.empty(layout.slots, dtype=torch.float32, device=dev)
    cnt = torch.empty(b, dtype=torch.int64, device=dev)
    g_keys, g_vals, err = _scratch(layout, dev)
    rc = load_kernels().bucket_reserve(
        table.data_ptr(), len(logs), layout.out_off.data_ptr(),
        layout.g_off.data_ptr(), g_keys.data_ptr(), g_vals.data_ptr(),
        ids.data_ptr(), None if out_sums is None else out_sums.data_ptr(),
        vals.data_ptr(), cnt.data_ptr(), err.data_ptr(), b, _stream(ids))
    check(rc, "bucket_reserve")
    bucket_reserve.launches += 1
    _check_tables(err, "bucket_reserve")
    bucket_reserve.global_sources = layout.global_sources
    return ids, out_sums, vals, cnt


bucket_hop.launches = 0
bucket_hop.global_sources = 0
bucket_reserve.launches = 0
bucket_reserve.global_sources = 0


def occupancy() -> dict:
    """What the card gives each kernel: resident CTAs an SM, shared bytes
    a CTA (the table and the static arrays), registers a thread and the
    shared table's slots (CUDA only)."""
    out = (ctypes.c_int * 7)()
    check(load_kernels().bucket_push_occupancy(out), "bucket_push_occupancy")
    return {name: {"ctas_per_sm": out[i], "smem_bytes": 12 * out[6]
                   + out[i + 1], "registers": out[i + 2],
                   "table_slots": out[6]}
            for name, i in (("bucket_hop", 0), ("bucket_reserve", 3))}


def _check_cuda(g: BucketPushGraph, tensors) -> None:
    if g.indptr.device.type != "cuda" or any(
            t.device != g.indptr.device for t in tensors):
        raise ValueError(f"bucket push: all tensors must be on the graph's "
                         f"CUDA device, not {g.indptr.device}")


def push_hop(g: BucketPushGraph, fr: Frontier, src: torch.Tensor,
             slots: int, layout: TableLayout | None = None) -> Frontier:
    """One hop from ``fr`` (sources ``src`` int32 [B]); ``slots`` is
    ``fr.exp.sum()``, which the caller has read, and ``layout``
    ``table_layout(fr.exp)`` where the caller has it. The next frontier's
    entries are in no particular order within a row."""
    if fr.ids.device.type == "cpu":
        return push_hop_plain(g, fr, src)
    return bucket_hop(g, fr, src, layout or table_layout(fr.exp))


def reserve_table_plain(g: BucketPushGraph, logs: list):
    """The reserve log merged per source, ``sum_i trunc(coef[i] * q_i)`` per
    node: (row_off int64 [B + 1], ids int32 ascending within each row, sums
    int64 Q62), what :func:`bucket_reserve` computes."""
    parts = []
    for fr, coef in logs:
        pos, rows = _entries(fr)
        c = (fr.q[pos].double() * coef).long()
        keep = c > 0
        parts.append((rows[keep], fr.ids[pos][keep].long(), c[keep]))
    _, ids, sums, cnt = _sum_by_key(
        g, *(torch.cat(p) for p in zip(*parts)), logs[0][0].cnt.numel())
    return row_offsets(cnt), ids, sums


def reserve_topk_plain(g: BucketPushGraph, logs: list, k: int):
    """Plain PyTorch version of :func:`reserve_topk`."""
    row_off, ids, sums = reserve_table_plain(g, logs)
    return push_topk_plain(ids, (sums.double() / ONE).float(), row_off, k)


def reserve_layout(logs: list) -> TableLayout:
    """:func:`table_layout` of the reserve tables: each source's entries
    over the whole log."""
    return table_layout(torch.stack([fr.cnt for fr, _ in logs]).sum(0))


def reserve_topk(g: BucketPushGraph, logs: list, k: int):
    """Merge the reserve log ``[(frontier of hop i, coef[i]), ...]`` into
    each source's reserves, ``sum_i trunc(coef[i] * q_i)`` per node, and
    keep the top k: (cols int32 [B, k], vals f32 [B, k]) on the device."""
    if logs[0][0].ids.device.type == "cpu":
        return reserve_topk_plain(g, logs, k)
    layout = reserve_layout(logs)
    ids, _, vals, _ = bucket_reserve(logs, layout)
    return push_topk(ids, vals, layout.out_off, k)


def by_row_and_id(off: torch.Tensor, cnt: torch.Tensor, ids: torch.Tensor,
                  *vals: torch.Tensor):
    """The entries of rows ``[off[b], off[b] + cnt[b])`` packed and ordered
    by row, then id: (ids, *vals). A kernel's rows, whose order within a
    row is the schedule's, compare with a plain version's this way."""
    fr = Frontier(off=off, cnt=cnt, ids=ids, q=ids, exp=cnt)
    pos, rows = _entries(fr)
    pos = pos[torch.argsort((rows << 32) + ids[pos].long())]
    return (ids[pos], *(v[pos] for v in vals))


def push_block(g: BucketPushGraph, src: torch.Tensor, coef: np.ndarray,
               k: int, slot_limit: int = 1 << 62, plain: bool = False):
    """P2 for the sources ``src`` (int32 [B] on ``g.device``): (cols int32
    [B, k], vals f32 [B, k]) on the device. Raises MemoryError when a hop
    needs more than ``slot_limit`` expansion slots. ``plain`` runs the plain
    versions on any device."""
    hop = (lambda g_, fr, s, *_: push_hop_plain(g_, fr, s)) if plain \
        else push_hop
    reserve = reserve_topk_plain if plain else reserve_topk
    n_hops = coef.shape[0] - 1
    fr = initial_frontier(g, src)
    logs = []
    for i in range(n_hops):
        logs.append((fr, float(coef[i])))
        layout = table_layout(fr.exp)      # the hop's one host read
        slots = layout.slots
        if slots == 0:                     # nothing pushes: no next frontier
            fr = None
            break
        if slots > slot_limit:
            raise MemoryError(f"gfpush_bucketed: a hop needs {slots} slots "
                              f"(> {slot_limit}); use a smaller block")
        fr = hop(g, fr, src, slots, layout)
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
