"""Peaks of the card and the least work of each part of a request or a
step, computed from shapes alone.

Bytes count each input read once and each output written once; a part's
least time is the larger of its bytes at the HBM rate and its operations at
the float32 rate (the port runs float32 with TF32 off). Where the work
depends on the data, only what every such input needs is counted, so that a
share of the roofline can never pass 100 % by counting too much.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_s(nbytes: float, flops: float = 0.0) -> float:
    """The least seconds of a part: its bytes or its operations, whichever
    bound it."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def hop_work(n: int, nnz: int, width: int) -> tuple:
    """(bytes, flops) of one fused power-iteration hop y = s * (P x),
    acc += y over a CSR operator of ``nnz`` entries: the operator (row
    pointers, ids, values), x read, y written, acc read and written."""
    return (4 * (n + 1) + 8 * nnz + 4 * 4 * n * width,
            2 * nnz * width + 2 * n * width)


def propagate_s(n: int, nnz: int, width: int, order: int) -> float:
    """Least seconds of ppr propagation: the start (x read, the scaled x
    and the accumulator written) and ``order`` hops, each bound on its
    own."""
    return (least_s(3 * 4 * n * width, n * width)
            + order * least_s(*hop_work(n, nnz, width)))


def mlp_work(n: int, dims: list, out: int) -> tuple:
    """(bytes, flops) of an eval-mode MLP over ``n`` rows whose layers are
    ``dims`` [(in, out), ...]: the input rows read once, the weights once,
    ``out`` columns of logits written once; 2 in*out flops a row a
    layer."""
    weights = sum(4 * (i * o + o) for i, o in dims)
    return (4 * n * dims[0][0] + weights + 4 * n * out,
            sum(2 * n * i * o for i, o in dims))


def embed_work(n: int, nnz: int, distinct_ids: int, width: int) -> tuple:
    """(bytes, flops) of the embedding mean of ``n`` nodes over ``nnz`` (id,
    value) entries: the entries (id and value) read once, each distinct
    table row once, the [n, width] output written once."""
    return (8 * nnz + 4 * distinct_ids * width + 4 * n * width,
            2 * nnz * width)
