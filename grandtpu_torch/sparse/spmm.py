"""SpMM hops of the power iteration: K2 and its fast-precision forms on
CSR, and K2-seg on padded COO.

Port of the math of ``grandtpu/sparse/spmm.py``: ``y = A @ x`` for the
row-normalized propagation operator ``A = D^-1 (adj + I)``. The TPU's
SplitCSR one-hot-matmul layout is not carried over; the operator is plain
CSR on the device, and SplitCSR's overflow level becomes the operator's
:class:`SplitPlan`, which every form of the CSR hop follows (K2, K2-bf16,
K2-q8, K2-q8mxu): each hub row is cut into chunks, each chunk summed apart
(K2-q8mxu in int32, so its split hop is bit for bit its unsplit one) and
the chunks added in order. Each hop is one step of the power iteration in
``grandtpu/infer/propagate.py`` with its update fused in:

    cur_out = scale * h;   acc += cur_out  (if accumulate)

where ``h`` is the hop's f32 product, by precision:

- :func:`spmm_prop_step` (K2, ``spmm_split(fast=False)``): sum of ``x[c]·v``;
- :func:`spmm_prop_step_bf16` (K2-bf16, ``fast=True``): each term
  ``x[c]·v`` rounded to bf16, summed in f32;
- :func:`spmm_prop_step_q8` (K2-q8, ``spmm_split_q8``) on the int8 columns
  of :func:`quantize_columns` (or of :func:`column_absmax` then
  :func:`quantize_with_amax`, its two launches, which a row-partitioned
  caller runs apart to share one scale across shards): terms
  ``bf16(q[c]·bf16(v))``, f32 sum, times the column scale. The int8 hops
  can also raise the column maxima of the output they store
  (``amax_out``), so that the next hop quantizes with
  :func:`quantize_with_amax` alone;
- :func:`spmm_prop_step_q8mxu` (K2-q8mxu, ``spmm_split_q8mxu``): the exact
  int32 sum of the gathered ``q`` rows, times the row value (the operator's
  rows must be constant, :func:`row_values_if_constant`) and the column
  scale. Edge values are not read.

An operator may be rectangular (``num_cols`` input rows): a shard's rows
over the gathered rows of the whole graph. :func:`spmm_segment_prop_step`
(K2-seg, ``spmm_segment`` and the update after it) is the same hop on a
:class:`PaddedCSR` (row-sorted COO, the low-memory backend, with its own
split plan), with an optional per-row scale for the row-partitioned
scatter variant; :func:`spmm_segment` is its bare product ``y = A @ x``.

The carries (``cur_in``/``cur_out``/``acc``) are f32, or bf16 for
grandtpu's ``bf16_carry``. With bf16 carries ``h`` is rounded to bf16, the
scale is rounded to bf16 before it multiplies (as JAX rounds a Python
scalar to a bf16 operand's type), and the product and the sum round to
bf16 each.

On CUDA tensors the wrappers launch ``csrc/csr_spmm.cu``,
``csrc/csr_spmm_q8.cu`` and ``csrc/coo_spmm.cu``; on CPU tensors they run
the ``*_plain`` versions, which repeat the kernels' arithmetic and
roundings and add each row's terms in the kernels' order (edge order; for
a split row, each chunk in edge order, then the chunks in order), so
that wherever the terms are rounded the same way (every form but K2's
fused multiply-add) a hop is bit for bit the kernel's.
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.ops._build import check, load_kernels

BF16 = torch.bfloat16


SPLIT_MIN_CAP = 512     # no row of at most this many nonzeros is split


def default_split_cap(num_rows: int, nnz: int) -> int:
    """The operator's own cap on a K2 work item: 8 times the mean row
    length, and at least :data:`SPLIT_MIN_CAP`. A row above it is a hub,
    whose one warp would finish long after the rest of the hop."""
    return max(SPLIT_MIN_CAP, 8 * -(-nnz // max(num_rows, 1)))


@dataclasses.dataclass
class SplitPlan:
    """The hub rows of a CSR operator cut into chunks of at most ``cap``
    edges (the port's counterpart of SplitCSR's overflow level,
    ``grandtpu/sparse/spmm.py:270-375``). Split row ``rows[i]`` has the
    chunks ``chunk_ptr[i]:chunk_ptr[i + 1]``; chunk ``c`` covers edges
    ``chunk_lo[c]:min(chunk_lo[c] + cap, indptr[row + 1])`` of row
    ``rows[chunk_row[c]]``. Chunks are in row order, and within a row in
    edge order. ``nnz``: the nonzeros of the split rows, counted on the
    host as the plan is built."""
    cap: int
    rows: torch.Tensor        # int32 [S], ascending
    chunk_ptr: torch.Tensor   # int32 [S + 1]
    chunk_row: torch.Tensor   # int32 [C], index into rows
    chunk_lo: torch.Tensor    # int32 [C]
    nnz: int

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_row.shape[0])

    @staticmethod
    def build(indptr: np.ndarray, cap: int, device) -> "SplitPlan | None":
        """The plan of the rows of ``indptr`` with more than ``cap``
        nonzeros; None when there is none."""
        if cap < 1:
            raise ValueError(f"SplitPlan: cap must be >= 1, got {cap}")
        indptr = np.asarray(indptr, np.int64)
        deg = np.diff(indptr)
        rows = np.flatnonzero(deg > cap)
        if rows.size == 0:
            return None
        per_row = -(-deg[rows] // cap)
        chunk_ptr = np.concatenate([[0], np.cumsum(per_row)])
        if chunk_ptr[-1] >= 2 ** 31:
            raise ValueError(f"SplitPlan: {chunk_ptr[-1]} chunks do not fit "
                             "int32")
        chunk_row = np.repeat(np.arange(rows.size), per_row)
        chunk_lo = (indptr[rows][chunk_row]
                    + (np.arange(chunk_row.size) - chunk_ptr[chunk_row])
                    * cap)
        return SplitPlan(cap, *(torch.as_tensor(a.astype(np.int32),
                                                device=device)
                                for a in (rows, chunk_ptr, chunk_row,
                                          chunk_lo)),
                         nnz=int(deg[rows].sum()))


@dataclasses.dataclass
class CSROperator:
    """A CSR matrix on a device: int32 structure, f32 values. Its hops read
    ``num_cols`` input rows (default: square) and write ``num_rows``.

    Building one builds its K2 split plan (:class:`SplitPlan`, None when no
    row has more than ``split_cap`` nonzeros) and ``counts``, what each
    hop does by the host's numbers: ``nnz``, and the rows, chunks and
    nonzeros that the split carries (0 without a plan). ``split_cap``
    defaults to :func:`default_split_cap`; a caller may set it (at least
    the longest row's length to run every row whole)."""
    indptr: torch.Tensor      # int32 [num_rows + 1]
    indices: torch.Tensor     # int32 [nnz], in [0, num_cols)
    values: torch.Tensor      # f32 [nnz]
    num_rows: int
    num_cols: int | None = None
    split_cap: int | None = None
    plan: SplitPlan | None = dataclasses.field(init=False, repr=False)
    counts: dict = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.num_cols is None:
            self.num_cols = self.num_rows
        if self.split_cap is None:
            self.split_cap = default_split_cap(self.num_rows, self.nnz)
        self.plan = SplitPlan.build(self.indptr.cpu().numpy(),
                                    self.split_cap, self.indptr.device)
        plan = self.plan
        self.counts = {
            "nnz": self.nnz,
            "split_rows": 0 if plan is None else int(plan.rows.shape[0]),
            "split_chunks": 0 if plan is None else plan.num_chunks,
            "split_nnz": 0 if plan is None else plan.nnz}

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_scipy(mat: sp.spmatrix, device,
                   split_cap: int | None = None) -> "CSROperator":
        mat = mat.tocsr()
        if mat.nnz >= 2 ** 31:
            raise ValueError("CSROperator: nnz must fit int32")
        return CSROperator(
            indptr=torch.as_tensor(mat.indptr.astype(np.int32),
                                   device=device),
            indices=torch.as_tensor(mat.indices.astype(np.int32),
                                    device=device),
            values=torch.as_tensor(mat.data.astype(np.float32),
                                   device=device),
            num_rows=mat.shape[0], num_cols=mat.shape[1],
            split_cap=split_cap)


def row_values_if_constant(adj: sp.spmatrix, rtol: float = 1e-6):
    """Per-row edge value if every row's nonzeros share one value (the
    D^-1 A propagation operator does), else None. Empty rows get 0.
    (A copy of ``grandtpu.sparse.spmm.row_values_if_constant``.)"""
    adj = adj.tocsr()
    n = adj.shape[0]
    if adj.nnz == 0:
        return np.zeros(n, np.float32)
    ends = adj.indptr[1:]
    starts = adj.indptr[:-1]
    has = ends > starts
    hrows = np.flatnonzero(has)
    first = np.zeros(n, np.float32)
    first[has] = adj.data[starts[hrows]]
    # a row is constant iff its signed max == signed min (O(nnz) reduceat)
    smax = np.maximum.reduceat(adj.data, starts[hrows])
    smin = np.minimum.reduceat(adj.data, starts[hrows])
    if np.any(smax - smin > rtol * np.maximum(np.abs(first[has]), 1e-30)):
        return None
    return first


def bf16_round(v: float) -> float:
    """``v`` rounded to the nearest bfloat16, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(BF16))


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of two bf16 tensors in units of the bf16
    ulp at the larger magnitude of the two (a diagnostic of how far a
    kernel's bf16 output is from its plain version's)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


def _row_sums(indptr: torch.Tensor, term,
              out: torch.Tensor) -> torch.Tensor:
    """``out[r] += term(e)`` for the edges ``e`` of each row ``r`` (edges
    ``indptr[r]:indptr[r + 1]``), added one at a time in edge order, as the
    kernels add them. ``term`` maps a
    tensor of edge ids to their [len, F] terms. The loop takes one slot of
    every row at a time (each row's j-th edge), so each element gets one
    add per step and the sums are the same on every device (CUDA's
    ``index_add_`` over all edges adds with atomics in any order)."""
    starts = indptr[:-1].long()
    return _ranged_sums(starts, indptr[1:].long() - starts, term, out)


def _ranged_sums(starts: torch.Tensor, deg: torch.Tensor, term,
                 out: torch.Tensor) -> torch.Tensor:
    """:func:`_row_sums` over the edges ``starts[r]:starts[r] + deg[r]``
    of each output row ``r``."""
    _, rows = torch.sort(deg, descending=True, stable=True)
    starts = starts[rows]
    # live[j]: the count of rows with more than j edges, a prefix of rows
    live = deg.numel() - torch.cumsum(torch.bincount(deg), 0)[:-1]
    for j, k in enumerate(live.tolist()):
        out.index_add_(0, rows[:k], term(starts[:k] + j))
    return out


def _epilogue_plain(h: torch.Tensor, cur_out: torch.Tensor,
                    acc: torch.Tensor | None, scale: float,
                    accumulate: bool) -> None:
    """``cur_out = scale * h``, ``acc += cur_out`` in the carries' dtype."""
    if cur_out.dtype == BF16:
        h, scale = h.to(BF16), bf16_round(scale)
    torch.mul(h, scale, out=cur_out)
    if accumulate:
        acc.add_(cur_out)


def _hop_sums(op: CSROperator, term, out: torch.Tensor) -> torch.Tensor:
    """``out[r] += term(e)`` over the edges of each row ``r``, grouped as
    the hop kernels group them under the operator's plan: a row under the
    cap in edge order; each chunk of a split row in edge order from 0, then
    the row's chunks in chunk order from 0."""
    plan = op.plan
    if plan is None:
        return _row_sums(op.indptr, term, out)
    starts = op.indptr[:-1].long()
    deg = op.indptr[1:].long() - starts
    split = plan.rows.long()
    whole = deg.clone()
    whole[split] = 0
    _ranged_sums(starts, whole, term, out)
    lo = plan.chunk_lo.long()
    hi = torch.minimum(lo + plan.cap,
                       op.indptr[1:].long()[split[plan.chunk_row.long()]])

    def zeros(rows):
        return torch.zeros((rows, out.shape[1]), dtype=out.dtype,
                           device=out.device)

    part = _ranged_sums(lo, hi - lo, term, zeros(plan.num_chunks))
    first = plan.chunk_ptr[:-1].long()
    out[split] = _ranged_sums(first, plan.chunk_ptr[1:].long() - first,
                              lambda c: part[c], zeros(split.numel()))
    return out


def spmm_prop_step_plain(op: CSROperator, cur_in: torch.Tensor,
                         cur_out: torch.Tensor, acc: torch.Tensor | None,
                         scale: float, accumulate: bool,
                         term: str = "f32") -> None:
    """Plain PyTorch version of K2 (``term="f32"``) and K2-bf16
    (``term="bf16"``): gather, scale, round, sum as the kernel groups the
    terms."""
    def prod(e):
        p = cur_in[op.indices[e].long()].float() * op.values[e, None]
        return p.to(BF16).float() if term == "bf16" else p

    h = _hop_sums(op, prod, torch.zeros(cur_out.shape,
                                        device=cur_out.device))
    _epilogue_plain(h, cur_out, acc, scale, accumulate)


def column_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`column_absmax`."""
    return x.abs().amax(0).float()


def quantize_with_amax_plain(x: torch.Tensor, amax: torch.Tensor,
                             zero_amax: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`quantize_with_amax`."""
    if zero_amax is not None:
        zero_amax.zero_()
    amax = amax.to(x.dtype)
    # in x's dtype, as grandtpu's ``amax / 127.0``, then f32; divided by a
    # tensor, since CUDA divides by a Python scalar as a reciprocal multiply
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        1.0).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_columns_plain(x: torch.Tensor):
    """Plain PyTorch version of :func:`quantize_columns`."""
    return quantize_with_amax_plain(x, column_absmax_plain(x))


def _raise_amax_plain(amax_out: torch.Tensor | None,
                      y: torch.Tensor) -> None:
    """The int8 hops' column maxima: ``amax_out = max(amax_out, max |y|)``
    over the columns of the stored ``y``."""
    if amax_out is not None:
        torch.maximum(amax_out, column_absmax_plain(y), out=amax_out)


def spmm_prop_step_q8_plain(op: CSROperator, q: torch.Tensor,
                            col_scale: torch.Tensor, cur_out: torch.Tensor,
                            acc: torch.Tensor | None, scale: float,
                            accumulate: bool,
                            amax_out: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of K2-q8 (f32 sums, grouped as the kernel's)."""
    vals = op.values.to(BF16).float()

    def prod(e):
        return (q[op.indices[e].long()].float()
                * vals[e, None]).to(BF16).float()

    h = _hop_sums(op, prod, torch.zeros(cur_out.shape,
                                        device=cur_out.device))
    _epilogue_plain(h * col_scale, cur_out, acc, scale, accumulate)
    _raise_amax_plain(amax_out, cur_out)


def spmm_prop_step_q8mxu_plain(op: CSROperator, q: torch.Tensor,
                               col_scale: torch.Tensor,
                               row_val: torch.Tensor, cur_out: torch.Tensor,
                               acc: torch.Tensor | None, scale: float,
                               accumulate: bool,
                               amax_out: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of K2-q8mxu (int32 sums)."""
    isum = _hop_sums(op, lambda e: q[op.indices[e].long()].int(),
                     torch.zeros(cur_out.shape, dtype=torch.int32,
                                 device=cur_out.device))
    h = isum.float() * row_val[:, None] * col_scale
    _epilogue_plain(h, cur_out, acc, scale, accumulate)
    _raise_amax_plain(amax_out, cur_out)


def _check_launch(name: str, op: CSROperator, x: torch.Tensor,
                  carries: list, extra: list) -> bool:
    """Checks of a hop wrapper on CUDA tensors; False when the hop has
    nothing to launch."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = carries + extra + [x, op.indptr, op.indices]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if (carries[0].dtype not in (torch.float32, BF16)
            or any(t.dtype != carries[0].dtype for t in carries)
            or op.indptr.dtype != torch.int32
            or op.indices.dtype != torch.int32):
        raise TypeError(f"{name} wants f32 or bf16 carries of one dtype "
                        "and int32 indptr/indices")
    nfeat = x.shape[1] if x.dim() == 2 else -1
    if (tuple(x.shape) != (op.num_cols, nfeat)
            or any(tuple(t.shape) != (op.num_rows, nfeat) for t in carries)):
        raise ValueError(f"{name}: the input must be [{op.num_cols}, F] and "
                         f"the carries [{op.num_rows}, F]")
    if x.data_ptr() == carries[0].data_ptr() and x.numel():
        raise ValueError(f"{name}: the input and cur_out must differ")
    return carries[0].numel() > 0


def _plan_args(name: str, op: CSROperator, x: torch.Tensor,
               partial_dtype: torch.dtype) -> tuple:
    """The split-plan arguments of a hop launch (the plan's four arrays,
    its chunk count and cap, the partial-sum scratch and the finish
    counters), and the scratch tensors, which the caller keeps until the
    launch is queued."""
    plan = op.plan
    if plan is None:
        return (None,) * 4 + (0, 0, None, None), ()
    tensors = (plan.rows, plan.chunk_ptr, plan.chunk_row, plan.chunk_lo)
    if any(t.device != x.device or t.dtype != torch.int32
           or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the split plan must be contiguous int32 "
                         f"on {x.device}")
    # each chunk's partial sums; one finish counter a split row
    partial = torch.empty((plan.num_chunks, x.shape[1]), dtype=partial_dtype,
                          device=x.device)
    counters = torch.zeros(plan.rows.shape[0], dtype=torch.int32,
                           device=x.device)
    return ((*(t.data_ptr() for t in tensors), plan.num_chunks, plan.cap,
             partial.data_ptr(), counters.data_ptr()), (partial, counters))


def _k2(op, cur_in, cur_out, acc, scale, accumulate, term, counter):
    if cur_in.device.type == "cpu":
        spmm_prop_step_plain(op, cur_in, cur_out, acc, scale, accumulate,
                             term)
        return
    carries = [cur_out] + ([acc] if accumulate else [])
    if cur_in.dtype != cur_out.dtype:
        raise TypeError(f"{counter.__name__}: cur_in and cur_out differ in "
                        "dtype")
    if op.values.dtype != torch.float32:
        raise TypeError(f"{counter.__name__} wants f32 operator values")
    if not _check_launch(counter.__name__, op, cur_in, carries, [op.values]):
        return
    bf16 = cur_out.dtype == BF16
    split, _scratch = _plan_args(counter.__name__, op, cur_in, torch.float32)
    rc = load_kernels().csr_spmm_prop(
        op.indptr.data_ptr(), op.indices.data_ptr(), op.values.data_ptr(),
        cur_in.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, op.num_rows,
        cur_in.shape[1], bf16_round(scale) if bf16 else float(scale),
        int(accumulate), int(term == "bf16"), int(bf16), *split,
        torch.cuda.current_stream(cur_in.device).cuda_stream)
    check(rc, "csr_spmm_prop")
    counter.launches += 1


def spmm_prop_step(op: CSROperator, cur_in: torch.Tensor,
                   cur_out: torch.Tensor, acc: torch.Tensor | None,
                   scale: float, accumulate: bool) -> None:
    """One K2 hop: ``cur_out = scale * (op @ cur_in)``, then
    ``acc += cur_out`` if ``accumulate``. Writes ``cur_out`` (and ``acc``)
    in place; the caller swaps ``cur_in`` and ``cur_out`` between hops.
    Carries [n, F] f32 (or all bf16), contiguous, ``cur_in`` not aliasing
    ``cur_out``."""
    _k2(op, cur_in, cur_out, acc, scale, accumulate, "f32", spmm_prop_step)


def spmm_prop_step_bf16(op: CSROperator, cur_in: torch.Tensor,
                        cur_out: torch.Tensor, acc: torch.Tensor | None,
                        scale: float, accumulate: bool) -> None:
    """One K2-bf16 hop: as :func:`spmm_prop_step` with each term rounded
    to bf16 before the f32 sum."""
    _k2(op, cur_in, cur_out, acc, scale, accumulate, "bf16",
        spmm_prop_step_bf16)


def _check_quantize(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, BF16) or x.dim() != 2:
        raise TypeError(f"{name} wants a 2-D f32 or bf16 tensor")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.shape[0] == 0:
        raise ValueError(f"{name}: x has no rows")


def _absmax_launch(x: torch.Tensor) -> torch.Tensor:
    # the kernel takes the max of non-negative floats as their bits
    amax = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    check(load_kernels().column_absmax(
        x.data_ptr(), amax.data_ptr(), x.shape[0], x.shape[1],
        int(x.dtype == BF16), torch.cuda.current_stream(x.device).cuda_stream),
        "column_absmax")
    return amax


def _check_amax(name: str, amax: torch.Tensor, x: torch.Tensor,
                what: str) -> None:
    if (amax.device != x.device or amax.dtype != torch.float32
            or amax.shape != (x.shape[1],) or not amax.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous f32 [F] "
                         f"tensor on {x.device}")


def _quantize_launch(x: torch.Tensor, amax: torch.Tensor,
                     zero_amax: torch.Tensor | None = None):
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    check(load_kernels().quantize_with_amax(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if zero_amax is None else zero_amax.data_ptr(),
        x.shape[0], x.shape[1], int(x.dtype == BF16),
        torch.cuda.current_stream(x.device).cuda_stream),
        "quantize_with_amax")
    return q, scale


def column_absmax(x: torch.Tensor) -> torch.Tensor:
    """``max |x[:, f]|`` of [n, F] f32 or bf16 ``x``, as f32 [F]: the first
    launch of :func:`quantize_columns`."""
    if x.device.type == "cpu":
        return column_absmax_plain(x)
    _check_quantize("column_absmax", x)
    if x.shape[1] == 0:
        return torch.zeros(0, device=x.device)
    amax = _absmax_launch(x)
    column_absmax.launches += 1
    return amax


def quantize_with_amax(x: torch.Tensor, amax: torch.Tensor,
                       zero_amax: torch.Tensor | None = None):
    """The quantize from given column maxima ``amax`` [F] f32 (of x, the
    max of every shard's, or what the previous int8 hop raised in its
    ``amax_out``: values of x's dtype), one launch: the scales ``amax /
    127`` in x's dtype (1 for a zero column) and ``q =
    clamp(round_half_even(x / scale), -127, 127)``. The same launch zeroes
    ``zero_amax`` [F] f32 if given (another buffer than ``amax``: the one
    the next hop raises), so the propagation's loop needs no fill a hop.
    Returns (q int8 [n, F], scale f32 [F])."""
    if x.device.type == "cpu":
        return quantize_with_amax_plain(x, amax, zero_amax)
    _check_quantize("quantize_with_amax", x)
    _check_amax("quantize_with_amax", amax, x, "amax")
    if zero_amax is not None:
        _check_amax("quantize_with_amax", zero_amax, x, "zero_amax")
        if zero_amax.data_ptr() == amax.data_ptr() and x.shape[1]:
            raise ValueError("quantize_with_amax: zero_amax must not be "
                             "amax")
    if x.shape[1] == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(0, device=x.device))
    out = _quantize_launch(x, amax, zero_amax)
    quantize_with_amax.launches += 1
    return out


def quantize_columns(x: torch.Tensor):
    """Per-column symmetric int8 quantization of [n, F] f32 or bf16 ``x``:
    ``scale = max|x[:, f]| / 127`` (1 for an all-zero column; rounded to
    bf16 when ``x`` is bf16, as grandtpu computes it in x's dtype) and
    ``q = clamp(round_half_even(x / scale), -127, 127)``. Returns
    (q int8 [n, F], scale f32 [F]). On CUDA, the launches of
    :func:`column_absmax` and :func:`quantize_with_amax`, counted as one
    call of this function: the first hop's quantize of an int8
    propagation, whose later hops take their maxima from the hop before
    (``amax_out``)."""
    if x.device.type == "cpu":
        return quantize_columns_plain(x)
    _check_quantize("quantize_columns", x)
    if x.shape[1] == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(0, device=x.device))
    out = _quantize_launch(x, _absmax_launch(x))
    quantize_columns.launches += 1
    return out


class Q8HopConfig(NamedTuple):
    """A launch configuration of the int8 hops (``csr_spmm_q8.cu``): a
    group of ``lanes`` lanes takes a row; each lane owns ``nper`` vectors
    of ``v`` neighbouring int8 features of each tile of
    ``lanes * nper * v`` features; ``u`` edges are gathered before their
    terms are added; ``minb`` blocks of 256 threads an SM."""
    lanes: int
    v: int
    nper: int
    u: int
    minb: int


# csr_spmm_q8.cu's pick_config: (nper, u, minb) for each vector width
_Q8_WIDTH_CONFIGS = {16: (1, 4, 4), 8: (1, 8, 4), 4: (2, 8, 4),
                     2: (2, 8, 4), 1: (4, 8, 3)}


def q8_hop_config(num_features: int, align_bytes: int) -> Q8HopConfig:
    """The configuration the K2-q8 and K2-q8mxu kernels launch with for
    ``num_features`` features when their arrays take ``align_bytes``
    features as one aligned vector (:func:`q8_hop_align`): the widest
    vector (16 bytes at most) that divides both, that width's
    ``(nper, u, minb)``, and the fewest lanes (a power of two up to 32)
    whose vectors cover a row. Mirrors ``csr_spmm_q8.cu::pick_config``
    (``csr_spmm_q8_config`` reports the kernel's own)."""
    if num_features < 1 or align_bytes < 1:
        raise ValueError("q8_hop_config: num_features and align_bytes must "
                         "be positive")
    v = 16
    while v > 1 and (num_features % v or align_bytes % v):
        v //= 2
    nper, u, minb = _Q8_WIDTH_CONFIGS[v]
    vecs = -(-num_features // v)
    lanes = 1
    while lanes < 32 and lanes * nper < vecs:
        lanes *= 2
    return Q8HopConfig(lanes, v, nper, u, minb)


def q8_hop_align(q: torch.Tensor, col_scale: torch.Tensor,
                 cur_out: torch.Tensor, acc: torch.Tensor | None) -> int:
    """The features (16 at most) that the int8 hop's arrays all take as
    one aligned vector: ``q`` aligned to that many bytes, the carries and
    the scales to that many elements or 16 bytes. Mirrors
    ``csr_spmm_q8.cu::hop_align``."""
    carry = cur_out.element_size()
    for v in (16, 8, 4, 2):
        cb, sb = min(v * carry, 16), min(v * 4, 16)
        if (q.data_ptr() % v == 0 and col_scale.data_ptr() % sb == 0
                and cur_out.data_ptr() % cb == 0
                and (acc is None or acc.data_ptr() % cb == 0)):
            return v
    return 1


def _q8_args(name, op, q, col_scale, cur_out, acc, accumulate, row_val,
             amax_out):
    if amax_out is not None:
        _check_amax(name, amax_out, q, "amax_out")
    carries = [cur_out] + ([acc] if accumulate else [])
    vec = [col_scale] + ([] if row_val is None else [row_val])
    if q.dtype != torch.int8 or any(t.dtype != torch.float32 for t in vec):
        raise TypeError(f"{name} wants int8 q and f32 scales/row values")
    if (q.dim() != 2 or col_scale.shape != (q.shape[1],)
            or (row_val is not None and row_val.shape != (op.num_rows,))):
        raise ValueError(f"{name}: col_scale must be [F] and row_val [n]")
    if row_val is None and op.values.dtype != torch.float32:
        raise TypeError(f"{name} wants f32 operator values")
    extra = vec + ([op.values] if row_val is None else [])
    return _check_launch(name, op, q, carries, extra)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def spmm_prop_step_q8(op: CSROperator, q: torch.Tensor,
                      col_scale: torch.Tensor, cur_out: torch.Tensor,
                      acc: torch.Tensor | None, scale: float,
                      accumulate: bool,
                      amax_out: torch.Tensor | None = None) -> None:
    """One K2-q8 hop on the quantized input (``q``, ``col_scale`` of
    :func:`quantize_columns`): ``h = (sum_e bf16(q[c]·bf16(v))) ·
    col_scale``, then the fused update into the carries. A hub row of the
    operator's plan is summed by chunks, then the chunks in order. With
    ``amax_out`` (f32 [F], zeroed by the caller) the hop also raises it to
    ``max |cur_out[:, f]|`` of the values it stores, the maxima the next
    hop's :func:`quantize_with_amax` takes."""
    if q.device.type == "cpu":
        spmm_prop_step_q8_plain(op, q, col_scale, cur_out, acc, scale,
                                accumulate, amax_out)
        return
    if not _q8_args("spmm_prop_step_q8", op, q, col_scale, cur_out, acc,
                    accumulate, None, amax_out):
        return
    bf16 = cur_out.dtype == BF16
    split, _scratch = _plan_args("spmm_prop_step_q8", op, q, torch.float32)
    rc = load_kernels().csr_spmm_q8(
        op.indptr.data_ptr(), op.indices.data_ptr(), op.values.data_ptr(),
        q.data_ptr(), col_scale.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, _ptr(amax_out), op.num_rows,
        q.shape[1],
        bf16_round(scale) if bf16 else float(scale), int(accumulate),
        int(bf16), *split, torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "csr_spmm_q8")
    spmm_prop_step_q8.launches += 1


def spmm_prop_step_q8mxu(op: CSROperator, q: torch.Tensor,
                         col_scale: torch.Tensor, row_val: torch.Tensor,
                         cur_out: torch.Tensor, acc: torch.Tensor | None,
                         scale: float, accumulate: bool,
                         amax_out: torch.Tensor | None = None) -> None:
    """One K2-q8mxu hop: ``h = (float(sum_e q[c]) · row_val[r]) ·
    col_scale`` with the sum exact in int32, then the fused update. The
    operator's values are not read: ``row_val`` [n] f32 stands for them.
    A hub row of the operator's plan is summed by chunks in int32, so the
    split hop equals the unsplit one bit for bit. ``amax_out`` as
    :func:`spmm_prop_step_q8`'s."""
    if q.device.type == "cpu":
        spmm_prop_step_q8mxu_plain(op, q, col_scale, row_val, cur_out, acc,
                                   scale, accumulate, amax_out)
        return
    if not _q8_args("spmm_prop_step_q8mxu", op, q, col_scale, cur_out, acc,
                    accumulate, row_val, amax_out):
        return
    bf16 = cur_out.dtype == BF16
    split, _scratch = _plan_args("spmm_prop_step_q8mxu", op, q, torch.int32)
    rc = load_kernels().csr_spmm_q8mxu(
        op.indptr.data_ptr(), op.indices.data_ptr(), row_val.data_ptr(),
        q.data_ptr(), col_scale.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, _ptr(amax_out), op.num_rows,
        q.shape[1],
        bf16_round(scale) if bf16 else float(scale), int(accumulate),
        int(bf16), *split, torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "csr_spmm_q8mxu")
    spmm_prop_step_q8mxu.launches += 1


@dataclasses.dataclass
class PaddedCSR:
    """COO edges sorted by row, padded to a multiple of ``chunk`` (the
    layout of ``grandtpu.sparse.spmm.PaddedCSR``): padding edges point at
    row ``num_nodes`` (one past the last) with value 0. Building one checks
    the layout, since K2-seg's sums are wrong on rows that are not sorted,
    and builds its hub-row split plan (:class:`SplitPlan` at
    :func:`default_split_cap`, None when no row is above it) from
    ``row_counts`` (each row's real edges, a host array; counted from
    ``rows`` when not given)."""
    rows: torch.Tensor   # int32 [E_pad], sorted, in [0, num_nodes]
    cols: torch.Tensor   # int32 [E_pad], in [0, num_cols)
    vals: torch.Tensor   # f32 [E_pad]
    num_nodes: int       # rows of the product
    chunk: int
    num_cols: int | None = None
    row_counts: dataclasses.InitVar[np.ndarray | None] = None
    plan: SplitPlan | None = dataclasses.field(init=False, repr=False)

    def __post_init__(self, row_counts):
        if self.num_cols is None:
            self.num_cols = self.num_nodes
        r, c, v = self.rows, self.cols, self.vals
        if (r.dtype != torch.int32 or c.dtype != torch.int32
                or v.dtype != torch.float32):
            raise TypeError("PaddedCSR wants int32 rows and cols, f32 vals")
        if not (r.dim() == c.dim() == v.dim() == 1
                and r.shape == c.shape == v.shape
                and len({r.device, c.device, v.device}) == 1
                and all(t.is_contiguous() for t in (r, c, v))):
            raise ValueError("PaddedCSR: rows, cols and vals must be 1-D, "
                             "contiguous, of one length, on one device")
        if r.numel() and (bool((r[1:] < r[:-1]).any())
                          or int(r[0]) < 0 or int(r[-1]) > self.num_nodes):
            raise ValueError("PaddedCSR: rows must be sorted and in "
                             f"[0, {self.num_nodes}]")
        if c.numel() and (int(c.min()) < 0 or int(c.max()) >= self.num_cols):
            raise ValueError(f"PaddedCSR: cols must be in [0, "
                             f"{self.num_cols})")
        if row_counts is None:
            row_counts = torch.bincount(
                r.long(), minlength=self.num_nodes + 1).cpu().numpy()
        counts = np.asarray(row_counts, np.int64)[: self.num_nodes]
        self.plan = SplitPlan.build(
            np.concatenate([[0], np.cumsum(counts)]),
            default_split_cap(self.num_nodes, int(counts.sum())), r.device)

    @property
    def num_edges_padded(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_scipy(adj: sp.spmatrix, chunk: int = 1 << 18,
                   device="cuda") -> "PaddedCSR":
        coo = adj.tocoo()
        order = np.argsort(coo.row, kind="stable")
        rows = coo.row[order].astype(np.int32)
        cols = coo.col[order].astype(np.int32)
        vals = coo.data[order].astype(np.float32)
        n = adj.shape[0]
        e = rows.shape[0]
        chunk = min(chunk, max(256, 1 << (max(e - 1, 1)).bit_length()))
        e_pad = -(-max(e, 1) // chunk) * chunk
        pad = e_pad - e
        counts = np.bincount(rows, minlength=n)
        rows = np.concatenate([rows, np.full(pad, n, dtype=np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, dtype=np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, dtype=np.float32)])
        return PaddedCSR(*(torch.as_tensor(a, device=device)
                           for a in (rows, cols, vals)), n, chunk,
                         num_cols=adj.shape[1], row_counts=counts)


def spmm_segment_prop_step_plain(padded: PaddedCSR, cur_in: torch.Tensor,
                                 cur_out: torch.Tensor,
                                 acc: torch.Tensor | None, scale: float,
                                 accumulate: bool,
                                 row_scale: torch.Tensor | None = None
                                 ) -> None:
    """Plain PyTorch version of :func:`spmm_segment_prop_step`: each row's
    f32 terms ``x[c]·v`` added in f32 in edge order (a split row's by
    chunks, then the chunks in order, as the kernel groups them), the
    padding skipped, then the update in the carries' dtype."""
    n = padded.num_nodes
    bounds = torch.arange(n + 1, dtype=torch.int32, device=cur_in.device)
    op = types.SimpleNamespace(
        indptr=torch.searchsorted(padded.rows, bounds), plan=padded.plan)
    h = _hop_sums(op, lambda e: cur_in[padded.cols[e].long()].float()
                  * padded.vals[e, None],
                  torch.zeros(cur_out.shape, device=cur_out.device))
    if row_scale is not None:
        h = h * row_scale[:, None]
    _epilogue_plain(h, cur_out, acc, scale, accumulate)


def _segment_launch(name: str, padded: PaddedCSR, x: torch.Tensor,
                    y: torch.Tensor, acc: torch.Tensor | None, scale: float,
                    accumulate: bool, row_scale: torch.Tensor | None) -> bool:
    """Checks and launches K2-seg; False when there was nothing to
    launch."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, nfeat = padded.num_nodes, x.shape[1] if x.dim() == 2 else -1
    carries = [y] + ([acc] if accumulate else [])
    tensors = [x, padded.rows, padded.cols, padded.vals] + carries + (
        [] if row_scale is None else [row_scale])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if (x.dtype not in (torch.float32, BF16)
            or any(t.dtype != x.dtype for t in carries)
            or (row_scale is not None and row_scale.dtype != torch.float32)):
        raise TypeError(f"{name} wants x and carries all f32 or all bf16, "
                        "and an f32 row scale")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if (tuple(x.shape) != (padded.num_cols, nfeat)
            or any(tuple(t.shape) != (n, nfeat) for t in carries)
            or (row_scale is not None and row_scale.shape != (n,))):
        raise ValueError(f"{name}: x must be [{padded.num_cols}, F], the "
                         f"carries [{n}, F] and the row scale [{n}]")
    if x.numel() and any(t.data_ptr() == x.data_ptr() for t in carries):
        raise ValueError(f"{name}: x must alias neither output")
    if not y.numel():
        return False
    plan = padded.plan
    split, _scratch = _plan_args(name, types.SimpleNamespace(plan=plan), x,
                                 torch.float32)
    bf16 = x.dtype == BF16
    check(load_kernels().coo_spmm(
        padded.rows.data_ptr(), padded.cols.data_ptr(),
        padded.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        acc.data_ptr() if accumulate else None, _ptr(row_scale),
        padded.num_edges_padded, n, nfeat,
        bf16_round(scale) if bf16 else float(scale), int(accumulate),
        int(bf16), *split,
        torch.cuda.current_stream(x.device).cuda_stream), "coo_spmm")
    return True


def spmm_segment_prop_step(padded: PaddedCSR, cur_in: torch.Tensor,
                           cur_out: torch.Tensor, acc: torch.Tensor | None,
                           scale: float, accumulate: bool,
                           row_scale: torch.Tensor | None = None) -> None:
    """One K2-seg hop with the update fused, in one launch: ``h = A @
    cur_in`` for ``A`` as :class:`PaddedCSR` (each row's terms in edge
    order), ``cur_out = scale * h`` (with ``row_scale`` [num_nodes] f32:
    ``(h · row_scale[r]) · scale``, two roundings, D1's scatter variant),
    then ``acc += cur_out`` if ``accumulate``. Carries [num_nodes, F]
    (every row written), ``cur_in`` [num_cols, F] aliasing neither, all
    f32, or all bf16: grandtpu's segment hop on bf16 carries (f32 terms
    summed in f32, ``h`` rounded to bf16, the update in bf16 with the
    scale rounded to bf16)."""
    if cur_in.device.type == "cpu":
        spmm_segment_prop_step_plain(padded, cur_in, cur_out, acc, scale,
                                     accumulate, row_scale)
        return
    if _segment_launch("spmm_segment_prop_step", padded, cur_in, cur_out,
                       acc, scale, accumulate, row_scale):
        spmm_segment_prop_step.launches += 1


def spmm_segment_plain(padded: PaddedCSR, x: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_segment`."""
    if out is None:
        out = torch.empty((padded.num_nodes, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    spmm_segment_prop_step_plain(padded, x, out, None, 1.0, False)
    return out


def spmm_segment(padded: PaddedCSR, x: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K2-seg's bare product ``y = A @ x`` for ``A`` as :class:`PaddedCSR`,
    ``x`` [num_cols, F] f32 or bf16: the hop's kernel with scale 1 and no
    update. Writes every row of ``out`` [num_nodes, F] of x's dtype (a new
    one if None) and returns it."""
    if out is not None and tuple(out.shape) != (padded.num_nodes,
                                                x.shape[-1]):
        raise ValueError(f"spmm_segment: out must be [{padded.num_nodes}, "
                         "F]")
    if x.device.type == "cpu":
        return spmm_segment_plain(padded, x, out)
    if out is None:
        out = torch.empty((padded.num_nodes, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    if _segment_launch("spmm_segment", padded, x, out, None, 1.0, False,
                       None):
        spmm_segment.launches += 1
    return out


for _fn in (spmm_prop_step, spmm_prop_step_bf16, quantize_columns,
            column_absmax, quantize_with_amax, spmm_prop_step_q8,
            spmm_prop_step_q8mxu, spmm_segment, spmm_segment_prop_step):
    _fn.launches = 0
