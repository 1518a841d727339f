"""Exact full-graph power-iteration propagation (port of
``grandtpu/infer/propagate.py``).

With adj already self-looped and D its row sums (``model.py:181-210``):

    ppr    : prop = sum_{t=0..order} [(1-a) D^-1 A]^t (a X)
    avg    : prop = sum_{t=0..order} (D^-1 A)^t X / (order+1)
    single : prop = (D^-1 A)^order X

Backends: 'dense' (``torch.matmul`` on the dense operator, n <= 20000,
as ``grandtpu`` leaves its dense path to XLA), 'csr' (the K2 kernels,
in place of ``grandtpu``'s SplitCSR; ``grandtpu``'s name 'block' is
accepted for it) and 'segment' (K2-seg on row-sorted padded COO, no row
pointers: the low-memory backend, explicit opt-in, as in ``grandtpu``).

Precisions on the 'csr' backend, as in ``grandtpu``: 'f32' (K2), 'bf16'
(K2-bf16: terms rounded to bf16), 'int8' (per-column int8 quantize each
hop, then K2-q8mxu when the operator's rows are constant, as D^-1 A's
are, else K2-q8), 'int8mxu' and 'int8cast' (force one of the two), and
'auto' (the ``calibrate()`` choice, else :func:`choose_fast_precision`).
``exact_propagate`` adds 'bf16_carry': bf16 terms AND bf16 carries (half
the [n, F] memory). The dense backend ignores the precision; so does the
'segment' one as grandtpu's does ('auto', 'bf16' and 'int8' run its f32
hop, 'int8mxu' and 'int8cast' raise). 'segment' with bf16 carries
(bf16_carry) runs K2-seg's bf16 form: f32 terms summed in f32, each row
rounded to bf16 once, the update in bf16, as grandtpu's scatter-add,
which promotes its bf16 accumulator to f32.

An int8 run quantizes its first hop's input in full (column maxima, then
the quantize); each later hop quantizes with the maxima that the hop
before it raised while storing its output (``amax_out``), so the input
is read once a hop, not twice. A max is exact in any order: q is the
same bits either way.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch import observe
from grandtpu_torch.device import resolve_device
from grandtpu_torch.sparse.spmm import (BF16, CSROperator, PaddedCSR,
                                        bf16_round, quantize_columns,
                                        quantize_with_amax,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8mxu,
                                        spmm_segment_prop_step)

DENSE_MAX_NODES = 20000   # grandtpu's dense_threshold: dense at n <= this

# grandtpu's measured fast-precision crossover and degree-skew guard, kept
# as they are so that 'auto' picks what grandtpu picks. Both were measured
# on a TPU v5e (grandtpu/infer/propagate.py:37-55); the H100's own
# crossover is for ``Propagator.calibrate`` to find.
INT8_MAX_WORKING_SET_BYTES = 1 << 30
INT8_MAX_HUB_DEGREE = 8192

PRECISIONS = ("auto", "f32", "bf16", "int8", "int8mxu", "int8cast")


def choose_fast_precision(num_rows: int, num_features: int,
                          max_degree: int | None = None) -> str:
    """grandtpu's heuristic fast precision: 'int8' while the f32 [n, F]
    carry is at most ``INT8_MAX_WORKING_SET_BYTES``, else 'bf16'; 'bf16'
    whenever ``max_degree`` (max nonzeros in an operator row, if known)
    reaches ``INT8_MAX_HUB_DEGREE``, where int8 noise on hub rows nears
    the 5e-3 gate."""
    if max_degree is not None and max_degree >= INT8_MAX_HUB_DEGREE:
        return "bf16"
    working_set = num_rows * num_features * 4   # the f32 [n, F] carry
    return "int8" if working_set <= INT8_MAX_WORKING_SET_BYTES else "bf16"


def _carry_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.bfloat16 for a torch dtype or any dtype numpy
    can name (grandtpu's callers pass ``jnp.float32``/``jnp.bfloat16``)."""
    if not isinstance(dtype, torch.dtype):
        dtype = {"float32": torch.float32,
                 "bfloat16": BF16}.get(np.dtype(dtype).name, dtype)
    if dtype not in (torch.float32, BF16):
        raise TypeError(f"the carries' dtype must be float32 or bfloat16, "
                        f"not {dtype}")
    return dtype


def _max_row_nnz(adj: sp.spmatrix) -> int:
    """Max nonzeros in any row, the quantity the int8 skew guard keys on."""
    return int(adj.getnnz(axis=1).max()) if adj.nnz else 0


class Propagator:
    """Device-resident propagation operator D^-1 A: build once, apply many
    times."""

    def __init__(self, adj: sp.spmatrix, *, dense_threshold: int = 20000,
                 backend: str | None = None, dtype=torch.float32,
                 rows_per_block: int | None = None, device="cuda"):
        """``dtype``: the carries' dtype, float32 or bfloat16 (a torch dtype,
        or one numpy can name, such as ``jnp.bfloat16``); bfloat16 also makes
        the dense operator bf16, as in grandtpu. ``rows_per_block`` is
        grandtpu's TPU row-block size; it is accepted and ignored, since the
        CSR kernels have no row blocks."""
        del rows_per_block
        dtype = _carry_dtype(dtype)
        self.device = resolve_device(device)
        n = adj.shape[0]
        self.max_degree = _max_row_nnz(adj)   # int8 skew-guard input
        deg = np.asarray(adj.sum(1)).flatten()
        dinv = 1.0 / np.maximum(deg, 1e-12)       # reference's 1e-12 clamp
        a_norm = sp.diags(dinv).dot(adj).tocsr()   # D^-1 A, folded once
        if backend is None:
            backend = "dense" if n <= dense_threshold else "csr"
        if backend == "block":
            backend = "csr"
        self.row_val = None
        if backend == "dense":
            self.adj_op = torch.as_tensor(
                np.asarray(a_norm.todense(), np.float32),
                device=self.device).to(dtype)
        elif backend == "csr":
            self.adj_op = CSROperator.from_scipy(a_norm, self.device)
            # D^-1 A's rows are constant (1/deg): int8 runs as K2-q8mxu
            rv = row_values_if_constant(a_norm)
            if rv is not None:
                self.row_val = torch.as_tensor(rv, device=self.device)
        elif backend == "segment":
            # K2-seg: f32 or bf16 carries, each row added in edge order by
            # its owner, no atomics
            self.adj_op = PaddedCSR.from_scipy(a_norm, device=self.device)
        else:
            raise ValueError(f"unknown propagation backend {backend!r} "
                             "(the port has 'dense', 'csr' = 'block' and "
                             "'segment')")
        self.backend = backend
        self.dtype = dtype
        self.num_rows = n
        self._auto_precision: str | None = None
        # the form the last call's hops ran (see _resolve)
        self.last_precision: str | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibrate(self, features, *, mode: str = "ppr", order: int = 5,
                  alpha: float = 0.2, candidates=("bf16", "int8"),
                  gate: float = 5e-3, repeats: int = 3) -> str:
        """Timed precision autotune on the real operands: runs f32 once as
        the accuracy reference, drops each candidate whose max error
        relative to max |f32| exceeds ``gate``, times the rest (``repeats``
        calls, synchronized) and caches the fastest for later
        ``precision="auto"`` calls. Returns it ('f32' if none passes)."""
        if self.backend != "csr":   # the dense backend ignores precision
            self._auto_precision = "f32"
            return "f32"
        x = torch.as_tensor(features, dtype=self.dtype, device=self.device)

        def run_sync(p):
            out = self(x, mode=mode, order=order, alpha=alpha, precision=p)
            self._sync()
            return out

        ref = run_sync("f32").float()
        scale = max(float(ref.abs().max()), 1e-9)
        best, best_dt = "f32", None
        for p in candidates:
            out = run_sync(p)   # the error sample (and any first-call cost)
            err = float((out.float() - ref).abs().max()) / scale
            if err > gate:
                continue
            t0 = time.perf_counter()
            for _ in range(repeats):
                out = self(x, mode=mode, order=order, alpha=alpha,
                           precision=p)
            self._sync()
            dt = (time.perf_counter() - t0) / repeats
            if best_dt is None or dt < best_dt:
                best, best_dt = p, dt
        self._auto_precision = best
        return best

    def _resolve(self, precision: str, num_features: int) -> str | None:
        """The form the hops run: 'f32', 'bf16', 'int8mxu' or 'int8cast'
        on the 'csr' backend ('int8' is K2-q8mxu where the operator's rows
        are constant, else K2-q8), 'f32' on the 'segment' one, None on the
        dense one."""
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if self.backend != "csr":
            if precision in ("int8mxu", "int8cast"):
                raise ValueError(f"{precision} applies to the 'csr' "
                                 "(= 'block') backend only")
            return "f32" if self.backend == "segment" else None
        if precision == "auto":
            precision = self._auto_precision or choose_fast_precision(
                self.num_rows, num_features, max_degree=self.max_degree)
        if precision == "int8mxu" and self.row_val is None:
            raise ValueError(
                "int8mxu needs row-constant operator values (D^-1 A has "
                "them; this operator does not) — use 'int8' instead")
        if precision == "int8":
            return "int8cast" if self.row_val is None else "int8mxu"
        return precision

    def _hop(self, precision: str | None, cur_in, cur_out, acc,
             scale: float, accumulate: bool, amax=(None, None)) -> None:
        """One hop. For the int8 forms ``amax`` is (the maxima of
        ``cur_in`` that the previous hop raised, None on the first hop; the
        buffer this hop raises, None on the last)."""
        if self.backend == "segment":
            spmm_segment_prop_step(self.adj_op, cur_in, cur_out, acc, scale,
                                   accumulate)
        elif precision is None:          # the dense backend
            h = torch.matmul(self.adj_op, cur_in)
            if cur_out.dtype == BF16:
                h, scale = h.to(BF16), bf16_round(scale)
            torch.mul(h, scale, out=cur_out)
            if accumulate:
                acc.add_(cur_out)
        elif precision == "f32":
            spmm_prop_step(self.adj_op, cur_in, cur_out, acc, scale,
                           accumulate)
        elif precision == "bf16":
            spmm_prop_step_bf16(self.adj_op, cur_in, cur_out, acc, scale,
                                accumulate)
        else:
            have, raise_ = amax
            if have is None:
                q, col_scale = quantize_columns(cur_in)
            else:
                q, col_scale = quantize_with_amax(cur_in, have, raise_)
            if precision == "int8mxu":
                spmm_prop_step_q8mxu(self.adj_op, q, col_scale, self.row_val,
                                     cur_out, acc, scale, accumulate, raise_)
            else:
                spmm_prop_step_q8(self.adj_op, q, col_scale, cur_out, acc,
                                  scale, accumulate, raise_)

    def _hop_counts(self, precision: str | None, x: torch.Tensor) -> dict:
        """The counts each hop's span carries on the 'csr' backend, from
        host numbers alone: the operator's (``nnz``, ``split_rows``,
        ``split_chunks``, ``split_nnz``) and ``gather_bytes``, the input
        rows its nonzeros gather (a carry element a feature, one byte for
        the int8 forms). None on the other backends' hops."""
        if self.backend != "csr":
            return {}
        item = 1 if precision in ("int8mxu", "int8cast") else x.element_size()
        return dict(self.adj_op.counts,
                    gather_bytes=self.adj_op.nnz * x.shape[1] * item)

    def __call__(self, features, *, mode: str = "ppr", order: int = 10,
                 alpha: float = 0.2, fast: bool = False,
                 precision: str | None = None) -> torch.Tensor:
        """Propagate [n, F] features (array or tensor); returns a tensor of
        the Propagator's dtype on its device. ``features`` is not written.
        precision: 'f32' (default), 'bf16' (== ``fast=True``, the legacy
        alias), 'int8', 'int8mxu', 'int8cast' or 'auto'; see the module
        docstring. The dense backend runs its matmul in ``dtype``. Sets
        ``last_precision`` to the form the hops ran: 'f32', 'bf16',
        'int8mxu' or 'int8cast', or None on the dense backend."""
        with observe.span("infer.propagate", device=self.device):
            return self._propagate(features, mode, order, alpha, fast,
                                   precision)

    def _propagate(self, features, mode, order, alpha, fast, precision):
        if precision is None:
            precision = "bf16" if fast else "f32"
        precision = self.last_precision = self._resolve(precision,
                                                        features.shape[1])
        x = torch.as_tensor(features, dtype=self.dtype,
                            device=self.device).contiguous()
        # with bf16 carries JAX rounds each Python scalar to bf16 first
        rnd = bf16_round if self.dtype == BF16 else float
        if mode == "ppr":
            cur_in = x * rnd(alpha)
            acc, scale, accumulate = cur_in.clone(), 1.0 - alpha, True
        elif mode == "avg":
            cur_in = x.clone()
            acc, scale, accumulate = x.clone(), 1.0, True
        elif mode == "single":
            cur_in, acc, scale, accumulate = x.clone(), None, 1.0, False
        else:
            raise ValueError(f"unknown propagation mode {mode!r}")
        cur_out = torch.empty_like(cur_in)
        # the int8 hops' column maxima: a pair of [F] buffers, one raised by
        # a hop while the next hop's quantize reads the other and zeroes
        # the first
        pair = (torch.zeros((2, x.shape[1]), device=self.device)
                if precision in ("int8mxu", "int8cast") else None)
        counts = self._hop_counts(precision, x)
        for t in range(order):
            amax = (None, None)
            if pair is not None:
                amax = (pair[(t - 1) % 2] if t else None,
                        pair[t % 2] if t + 1 < order else None)
            with observe.span("infer.propagate.hop",
                              device=self.device) as hop:
                self._hop(precision, cur_in, cur_out, acc, scale,
                          accumulate, amax)
                for key, n in counts.items():
                    hop.add(key, n)
            # the one in-place update of the port's propagation: two [n, F]
            # carries, swapped every hop (the hop reads one, writes the other)
            cur_in, cur_out = cur_out, cur_in
        if mode == "ppr":
            return acc
        if mode == "avg":
            return acc.div_(rnd(order + 1))
        return cur_in


def exact_propagate(adj: sp.spmatrix, features, *, mode: str = "ppr",
                    order: int = 10, alpha: float = 0.2,
                    dense_threshold: int = 20000,
                    backend: str | None = None, fast: bool = False,
                    precision: str | None = None, dtype=torch.float32,
                    rows_per_block: int | None = None,
                    device="cuda") -> torch.Tensor:
    """One-shot propagation of [n, F] features through the self-looped
    adjacency (builds a Propagator and applies it).

    precision as :meth:`Propagator.__call__`, plus 'bf16_carry' (bf16 terms
    and bf16 carries: the [n, F] memory halves, the error grows with
    order; the result is bf16). 'auto' is resolved here, before the
    build, from the graph's size and largest row, as grandtpu does.
    ``rows_per_block`` is accepted and ignored (a TPU layout knob)."""
    del rows_per_block
    prop, precision = exact_propagator(
        adj, features.shape[1], dense_threshold=dense_threshold,
        backend=backend, precision=precision, dtype=dtype, device=device)
    return prop(features, mode=mode, order=order, alpha=alpha, fast=fast,
                precision=precision)


def exact_propagator(adj: sp.spmatrix, num_features: int, *,
                     dense_threshold: int = 20000, backend: str | None = None,
                     precision: str | None = None, dtype=torch.float32,
                     device="cuda") -> tuple[Propagator, str | None]:
    """The Propagator that :func:`exact_propagate` builds for [n,
    ``num_features``] features, and the precision to call it with:
    'bf16_carry' becomes 'bf16' on bf16 carries, and 'auto' is resolved
    here, before the build, from the graph's size and largest row, as
    grandtpu does."""
    if precision == "bf16_carry":
        precision, dtype = "bf16", BF16
    if precision == "auto":
        precision = choose_fast_precision(adj.shape[0], num_features,
                                          max_degree=_max_row_nnz(adj))
    prop = Propagator(adj, dense_threshold=dense_threshold, backend=backend,
                      dtype=dtype, device=device)
    return prop, precision
