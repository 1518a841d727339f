"""Exact full-graph power-iteration propagation (port of
``grandtpu/infer/propagate.py``, f32 only).

With adj already self-looped and D its row sums (``model.py:181-210``):

    ppr    : prop = sum_{t=0..order} [(1-a) D^-1 A]^t (a X)
    avg    : prop = sum_{t=0..order} (D^-1 A)^t X / (order+1)
    single : prop = (D^-1 A)^order X

Backends: 'dense' (``torch.matmul`` on the dense operator, n <= 20000,
as ``grandtpu`` leaves its dense path to XLA) and 'csr' (the K2 kernel,
in place of ``grandtpu``'s SplitCSR 'block'). The bf16/int8 precisions and
the 'segment' backend are ROADMAP Queue A items.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.device import resolve_device
from grandtpu_torch.sparse.spmm import CSROperator, spmm_prop_step

DENSE_MAX_NODES = 20000   # grandtpu's dense_threshold: dense at n <= this


class Propagator:
    """Device-resident propagation operator D^-1 A: build once, apply many
    times."""

    def __init__(self, adj: sp.spmatrix, *, backend: str | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        n = adj.shape[0]
        deg = np.asarray(adj.sum(1)).flatten()
        dinv = 1.0 / np.maximum(deg, 1e-12)       # reference's 1e-12 clamp
        a_norm = sp.diags(dinv).dot(adj).tocsr()   # D^-1 A, folded once
        if backend is None:
            backend = "dense" if n <= DENSE_MAX_NODES else "csr"
        if backend == "dense":
            self.adj_op = torch.as_tensor(
                np.asarray(a_norm.todense(), np.float32), device=self.device)
        elif backend == "csr":
            self.adj_op = CSROperator.from_scipy(a_norm, self.device)
        else:
            raise ValueError(f"unknown propagation backend {backend!r} "
                             "(the port has 'dense' and 'csr')")
        self.backend = backend
        self.num_rows = n

    def _hop(self, cur_in, cur_out, acc, scale: float, accumulate: bool):
        if self.backend == "csr":
            spmm_prop_step(self.adj_op, cur_in, cur_out, acc, scale,
                           accumulate)
            return
        torch.matmul(self.adj_op, cur_in, out=cur_out)
        cur_out.mul_(scale)
        if accumulate:
            acc.add_(cur_out)

    def __call__(self, features, *, mode: str = "ppr", order: int = 10,
                 alpha: float = 0.2) -> torch.Tensor:
        """Propagate [n, F] features (array or tensor); returns an f32
        tensor on the operator's device. ``features`` is not written."""
        x = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device).contiguous()
        if mode == "ppr":
            cur_in = alpha * x
            acc, scale, accumulate = cur_in.clone(), 1.0 - alpha, True
        elif mode == "avg":
            cur_in = x.clone()
            acc, scale, accumulate = x.clone(), 1.0, True
        elif mode == "single":
            cur_in, acc, scale, accumulate = x.clone(), None, 1.0, False
        else:
            raise ValueError(f"unknown propagation mode {mode!r}")
        cur_out = torch.empty_like(cur_in)
        for _ in range(order):
            self._hop(cur_in, cur_out, acc, scale, accumulate)
            # the one in-place update of the port's propagation: two [n, F]
            # carries, swapped every hop (the hop reads one, writes the other)
            cur_in, cur_out = cur_out, cur_in
        if mode == "ppr":
            return acc
        if mode == "avg":
            return acc.div_(order + 1)
        return cur_in


def exact_propagate(adj: sp.spmatrix, features, *, mode: str = "ppr",
                    order: int = 10, alpha: float = 0.2,
                    backend: str | None = None, precision: str = "f32",
                    device="cuda") -> torch.Tensor:
    """One-shot propagation of [n, F] features through the self-looped
    adjacency (builds a Propagator and applies it)."""
    if precision != "f32":
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet (ROADMAP Queue A: "
            "K2-q8 and K2-q8mxu with their precisions)")
    prop = Propagator(adj, backend=backend, device=device)
    return prop(features, mode=mode, order=order, alpha=alpha)
