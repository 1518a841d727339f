"""SpMM hops of the power iteration: K2 and its fast-precision forms on
CSR, and K2-seg on padded COO.

Port of the math of ``grandtpu/sparse/spmm.py``: ``y = A @ x`` for the
row-normalized propagation operator ``A = D^-1 (adj + I)``. The TPU's
SplitCSR one-hot-matmul layout is not carried over; the operator is plain
CSR on the device. Each hop is one step of the power iteration in
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
  ``bf16(q[c]·bf16(v))``, f32 sum, times the column scale;
- :func:`spmm_prop_step_q8mxu` (K2-q8mxu, ``spmm_split_q8mxu``): the exact
  int32 sum of the gathered ``q`` rows, times the row value (the operator's
  rows must be constant, :func:`row_values_if_constant`) and the column
  scale. Edge values are not read.

An operator may be rectangular (``num_cols`` input rows): a shard's rows
over the gathered rows of the whole graph. :func:`spmm_segment` (K2-seg,
``spmm_segment``) is the plain product ``y = A @ x`` of a :class:`PaddedCSR`
(row-sorted COO, the low-memory backend), without the update, as in
grandtpu.

The carries (``cur_in``/``cur_out``/``acc``) are f32, or bf16 for
grandtpu's ``bf16_carry``. With bf16 carries ``h`` is rounded to bf16, the
scale is rounded to bf16 before it multiplies (as JAX rounds a Python
scalar to a bf16 operand's type), and the product and the sum round to
bf16 each.

On CUDA tensors the wrappers launch ``csrc/csr_spmm.cu``,
``csrc/csr_spmm_q8.cu`` and ``csrc/coo_spmm.cu``; on CPU tensors they run
the ``*_plain`` versions, which repeat the kernels' arithmetic and
roundings and add each row's terms in the kernels' order (edge order), so
that wherever the terms are rounded the same way (every form but K2's
fused multiply-add) a hop is bit for bit the kernel's (K2-seg: but for the
rows that span several of its edge runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.ops._build import check, load_kernels

BF16 = torch.bfloat16


@dataclasses.dataclass
class CSROperator:
    """A CSR matrix on a device: int32 structure, f32 values. Its hops read
    ``num_cols`` input rows (default: square) and write ``num_rows``."""
    indptr: torch.Tensor      # int32 [num_rows + 1]
    indices: torch.Tensor     # int32 [nnz], in [0, num_cols)
    values: torch.Tensor      # f32 [nnz]
    num_rows: int
    num_cols: int | None = None

    def __post_init__(self):
        if self.num_cols is None:
            self.num_cols = self.num_rows

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_scipy(mat: sp.spmatrix, device) -> "CSROperator":
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
            num_rows=mat.shape[0], num_cols=mat.shape[1])


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
    deg = indptr[1:].long() - starts
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


def spmm_prop_step_plain(op: CSROperator, cur_in: torch.Tensor,
                         cur_out: torch.Tensor, acc: torch.Tensor | None,
                         scale: float, accumulate: bool,
                         term: str = "f32") -> None:
    """Plain PyTorch version of K2 (``term="f32"``) and K2-bf16
    (``term="bf16"``): gather, scale, round, sum in edge order."""
    def prod(e):
        p = cur_in[op.indices[e].long()].float() * op.values[e, None]
        return p.to(BF16).float() if term == "bf16" else p

    h = _row_sums(op.indptr, prod, torch.zeros(cur_out.shape,
                                               device=cur_out.device))
    _epilogue_plain(h, cur_out, acc, scale, accumulate)


def column_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`column_absmax`."""
    return x.abs().amax(0).float()


def quantize_with_amax_plain(x: torch.Tensor, amax: torch.Tensor):
    """Plain PyTorch version of :func:`quantize_with_amax`."""
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


def spmm_prop_step_q8_plain(op: CSROperator, q: torch.Tensor,
                            col_scale: torch.Tensor, cur_out: torch.Tensor,
                            acc: torch.Tensor | None, scale: float,
                            accumulate: bool) -> None:
    """Plain PyTorch version of K2-q8."""
    vals = op.values.to(BF16).float()

    def prod(e):
        return (q[op.indices[e].long()].float()
                * vals[e, None]).to(BF16).float()

    h = _row_sums(op.indptr, prod, torch.zeros(cur_out.shape,
                                               device=cur_out.device))
    _epilogue_plain(h * col_scale, cur_out, acc, scale, accumulate)


def spmm_prop_step_q8mxu_plain(op: CSROperator, q: torch.Tensor,
                               col_scale: torch.Tensor,
                               row_val: torch.Tensor, cur_out: torch.Tensor,
                               acc: torch.Tensor | None, scale: float,
                               accumulate: bool) -> None:
    """Plain PyTorch version of K2-q8mxu (int32 sums)."""
    isum = _row_sums(op.indptr, lambda e: q[op.indices[e].long()].int(),
                     torch.zeros(cur_out.shape, dtype=torch.int32,
                                 device=cur_out.device))
    h = isum.float() * row_val[:, None] * col_scale
    _epilogue_plain(h, cur_out, acc, scale, accumulate)


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
    rc = load_kernels().csr_spmm_prop(
        op.indptr.data_ptr(), op.indices.data_ptr(), op.values.data_ptr(),
        cur_in.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, op.num_rows,
        cur_in.shape[1], bf16_round(scale) if bf16 else float(scale),
        int(accumulate), int(term == "bf16"), int(bf16),
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


def _quantize_launch(x: torch.Tensor, amax: torch.Tensor):
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    check(load_kernels().quantize_with_amax(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(),
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


def quantize_with_amax(x: torch.Tensor, amax: torch.Tensor):
    """The second launch of :func:`quantize_columns`, from given column
    maxima ``amax`` [F] f32 (of x, or the max of every shard's, so values
    of x's dtype): the scales
    ``amax / 127`` in x's dtype (1 for a zero column) and
    ``q = clamp(round_half_even(x / scale), -127, 127)``. Returns (q int8
    [n, F], scale f32 [F])."""
    if x.device.type == "cpu":
        return quantize_with_amax_plain(x, amax)
    _check_quantize("quantize_with_amax", x)
    if (amax.device != x.device or amax.dtype != torch.float32
            or amax.shape != (x.shape[1],) or not amax.is_contiguous()):
        raise ValueError("quantize_with_amax: amax must be a contiguous f32 "
                         f"[F] tensor on {x.device}")
    if x.shape[1] == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(0, device=x.device))
    out = _quantize_launch(x, amax)
    quantize_with_amax.launches += 1
    return out


def quantize_columns(x: torch.Tensor):
    """Per-column symmetric int8 quantization of [n, F] f32 or bf16 ``x``:
    ``scale = max|x[:, f]| / 127`` (1 for an all-zero column; rounded to
    bf16 when ``x`` is bf16, as grandtpu computes it in x's dtype) and
    ``q = clamp(round_half_even(x / scale), -127, 127)``. Returns
    (q int8 [n, F], scale f32 [F]). On CUDA, the launches of
    :func:`column_absmax` and :func:`quantize_with_amax`, counted as one
    call of this function."""
    if x.device.type == "cpu":
        return quantize_columns_plain(x)
    _check_quantize("quantize_columns", x)
    if x.shape[1] == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(0, device=x.device))
    out = _quantize_launch(x, _absmax_launch(x))
    quantize_columns.launches += 1
    return out


def _q8_args(name, op, q, col_scale, cur_out, acc, accumulate, row_val):
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


def spmm_prop_step_q8(op: CSROperator, q: torch.Tensor,
                      col_scale: torch.Tensor, cur_out: torch.Tensor,
                      acc: torch.Tensor | None, scale: float,
                      accumulate: bool) -> None:
    """One K2-q8 hop on the quantized input (``q``, ``col_scale`` of
    :func:`quantize_columns`): ``h = (sum_e bf16(q[c]·bf16(v))) ·
    col_scale``, then the fused update into the carries."""
    if q.device.type == "cpu":
        spmm_prop_step_q8_plain(op, q, col_scale, cur_out, acc, scale,
                                accumulate)
        return
    if not _q8_args("spmm_prop_step_q8", op, q, col_scale, cur_out, acc,
                    accumulate, None):
        return
    bf16 = cur_out.dtype == BF16
    rc = load_kernels().csr_spmm_q8(
        op.indptr.data_ptr(), op.indices.data_ptr(), op.values.data_ptr(),
        q.data_ptr(), col_scale.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, op.num_rows, q.shape[1],
        bf16_round(scale) if bf16 else float(scale), int(accumulate),
        int(bf16), torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "csr_spmm_q8")
    spmm_prop_step_q8.launches += 1


def spmm_prop_step_q8mxu(op: CSROperator, q: torch.Tensor,
                         col_scale: torch.Tensor, row_val: torch.Tensor,
                         cur_out: torch.Tensor, acc: torch.Tensor | None,
                         scale: float, accumulate: bool) -> None:
    """One K2-q8mxu hop: ``h = (float(sum_e q[c]) · row_val[r]) ·
    col_scale`` with the sum exact in int32, then the fused update. The
    operator's values are not read: ``row_val`` [n] f32 stands for them."""
    if q.device.type == "cpu":
        spmm_prop_step_q8mxu_plain(op, q, col_scale, row_val, cur_out, acc,
                                   scale, accumulate)
        return
    if not _q8_args("spmm_prop_step_q8mxu", op, q, col_scale, cur_out, acc,
                    accumulate, row_val):
        return
    bf16 = cur_out.dtype == BF16
    rc = load_kernels().csr_spmm_q8mxu(
        op.indptr.data_ptr(), op.indices.data_ptr(), row_val.data_ptr(),
        q.data_ptr(), col_scale.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None, op.num_rows, q.shape[1],
        bf16_round(scale) if bf16 else float(scale), int(accumulate),
        int(bf16), torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "csr_spmm_q8mxu")
    spmm_prop_step_q8mxu.launches += 1


@dataclasses.dataclass
class PaddedCSR:
    """COO edges sorted by row, padded to a multiple of ``chunk`` (the
    layout of ``grandtpu.sparse.spmm.PaddedCSR``): padding edges point at
    row ``num_nodes`` (one past the last) with value 0, so they land in a
    discard row. Building one checks the layout, since K2-seg's sums are
    wrong on rows that are not sorted."""
    rows: torch.Tensor   # int32 [E_pad], sorted, in [0, num_nodes]
    cols: torch.Tensor   # int32 [E_pad], in [0, num_cols)
    vals: torch.Tensor   # f32 [E_pad]
    num_nodes: int       # rows of the product
    chunk: int
    num_cols: int | None = None

    def __post_init__(self):
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
        rows = np.concatenate([rows, np.full(pad, n, dtype=np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, dtype=np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, dtype=np.float32)])
        return PaddedCSR(*(torch.as_tensor(a, device=device)
                           for a in (rows, cols, vals)), n, chunk,
                         num_cols=adj.shape[1])


def spmm_segment_plain(padded: PaddedCSR, x: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_segment`: each row's terms
    ``x[c]·v`` added in edge order. The padding is skipped, as the kernel
    skips it, so the discard row stays zero."""
    n = padded.num_nodes
    if out is None:
        out = torch.zeros((n + 1, x.shape[1]), device=x.device)
    else:
        out.zero_()
    bounds = torch.arange(n + 1, dtype=torch.int32, device=x.device)
    indptr = torch.searchsorted(padded.rows, bounds)
    _row_sums(indptr, lambda e: x[padded.cols[e].long()]
              * padded.vals[e, None], out)
    return out[:n]


def spmm_segment(padded: PaddedCSR, x: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K2-seg: ``y = A @ x`` for ``A`` as :class:`PaddedCSR`, ``x``
    [num_cols, F] f32. Adds into ``out`` [num_nodes + 1, F] f32 (zeroed
    here; a new one if None), whose last row is the discard row, and
    returns its first ``num_nodes`` rows."""
    if x.device.type == "cpu":
        return spmm_segment_plain(padded, x, out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = padded.num_nodes
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError("spmm_segment wants a contiguous 2-D f32 x")
    if x.shape[0] != padded.num_cols:
        raise ValueError(f"spmm_segment: x must be [{padded.num_cols}, F]")
    if out is None:
        out = torch.zeros((n + 1, x.shape[1]), device=x.device)
    elif (out.shape != (n + 1, x.shape[1]) or out.dtype != torch.float32
          or not out.is_contiguous()):
        raise ValueError(f"spmm_segment: out must be a contiguous f32 "
                         f"[{n + 1}, {x.shape[1]}] tensor")
    else:
        out.zero_()
    if any(t.device != x.device for t in (padded.rows, out)):
        raise ValueError(f"spmm_segment: all tensors must be on {x.device}")
    if out.data_ptr() == x.data_ptr() and x.numel():
        raise ValueError("spmm_segment: x and out must differ")
    if out.numel() and padded.num_edges_padded:
        check(load_kernels().coo_spmm(
            padded.rows.data_ptr(), padded.cols.data_ptr(),
            padded.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            padded.num_edges_padded, n, x.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream), "coo_spmm")
        spmm_segment.launches += 1
    return out[:n]


for _fn in (spmm_prop_step, spmm_prop_step_bf16, quantize_columns,
            column_absmax, quantize_with_amax, spmm_prop_step_q8,
            spmm_prop_step_q8mxu, spmm_segment):
    _fn.launches = 0
