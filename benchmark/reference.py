"""The plain reference: GRAND+'s full-graph predict in plain torch
operations, from the stand-in's raw arrays and the benchmark's own weights.

It imports nothing of the port and takes nothing the port made: it builds
D^-1 (A + I) again from the raw adjacency and embeds from the raw CSR
features. Everything runs in float32 with TF32 off
unless ``tf32`` asks for the control: TF32 is the nearest precision below
the configurations' float32 with TF32 off, and the control rounds every
matmul operand to TF32's 10 mantissa bits (round to nearest even), as the
tensor cores do, and adds the products in float32, on any device.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import scipy.sparse as sp
import torch

BN_EPS = 1e-5
BLOCK_ROWS = 1 << 18


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off in matmuls inside, whatever the process set."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b in float32, with TF32 operands for the control."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b



def coo(rows, cols, vals, shape) -> torch.Tensor:
    """A coalesced sparse COO tensor (invariants unchecked: built here)."""
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                   check_invariants=False).coalesce()


def to_csr(t: torch.Tensor) -> torch.Tensor:
    """``t`` as sparse CSR, without torch's note that CSR is in beta."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor")
        return t.to_sparse_csr()


def _csr_tensor(m: sp.csr_matrix, device) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor")
        return torch.sparse_csr_tensor(
            torch.as_tensor(m.indptr.astype(np.int64), device=device),
            torch.as_tensor(m.indices.astype(np.int64), device=device),
            torch.as_tensor(m.data.astype(np.float32), device=device),
            size=m.shape, check_invariants=False)


def self_looped(adj: sp.csr_matrix, device) -> tuple:
    """(rows, cols, values) of A + I on ``device``, coalesced (row-major)."""
    n = adj.shape[0]
    counts = torch.as_tensor(np.diff(adj.indptr).astype(np.int64),
                             device=device)
    ar = torch.arange(n, device=device)
    rows = torch.cat([torch.repeat_interleave(ar, counts), ar])
    cols = torch.cat([torch.as_tensor(adj.indices.astype(np.int64),
                                      device=device), ar])
    vals = torch.cat([torch.as_tensor(adj.data.astype(np.float32),
                                      device=device),
                      torch.ones(n, device=device)])
    a = coo(rows, cols, vals, (n, n))
    idx = a.indices()
    return idx[0], idx[1], a.values()


def operator(adj: sp.csr_matrix, device) -> torch.Tensor:
    """D^-1 (A + I) as a sparse CSR tensor, D the row sums of A + I."""
    rows, cols, vals = self_looped(adj, device)
    n = adj.shape[0]
    deg = torch.zeros(n, device=device).index_add_(0, rows, vals)
    vals = vals / deg.clamp(min=1e-12)[rows]
    return to_csr(coo(rows, cols, vals, (n, n)))


def propagate(op: torch.Tensor, x: torch.Tensor, mode: str, order: int,
              alpha: float) -> torch.Tensor:
    """sum_t coef_t (D^-1 A)^t x, as GRAND+'s exact propagation:
    ppr sum_{t<=order} a (1-a)^t P^t x; avg the mean of P^t x; single
    P^order x."""
    if mode == "ppr":
        cur = x * alpha
        acc = cur.clone()
        for _ in range(order):
            cur = torch.sparse.mm(op, cur) * (1.0 - alpha)
            acc += cur
        return acc
    cur, acc = x, x.clone()
    for _ in range(order):
        cur = torch.sparse.mm(op, cur)
        acc += cur
    return acc / (order + 1) if mode == "avg" else cur


def node_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def batch_norm_eval(x: torch.Tensor, p: dict, i: int) -> torch.Tensor:
    return ((x - p[f"bns.{i}.running_mean"])
            / torch.sqrt(p[f"bns.{i}.running_var"] + BN_EPS)
            * p[f"bns.{i}.weight"] + p[f"bns.{i}.bias"])


def mlp_logits(x: torch.Tensor, p: dict, cfg: dict,
               tf32: bool = False) -> torch.Tensor:
    """The dense engine's classifier in eval mode: [node_norm] -> [BN] -> fc,
    then per hidden layer relu -> [node_norm] -> [BN] -> fc."""
    if cfg["node_norm"]:
        x = node_normalize(x)
    if cfg["use_bn"]:
        x = batch_norm_eval(x, p, 0)
    x = mm(x, p["fcs.0.weight"].T, tf32) + p["fcs.0.bias"]
    for i in range(1, cfg["nlayers"]):
        x = torch.relu(x)
        if cfg["node_norm"]:
            x = node_normalize(x)
        if cfg["use_bn"]:
            x = batch_norm_eval(x, p, i)
        x = mm(x, p[f"fcs.{i}.weight"].T, tf32) + p[f"fcs.{i}.bias"]
    return x


def mag_head(x: torch.Tensor, p: dict, cfg: dict,
             tf32: bool = False) -> torch.Tensor:
    """The MAG model's head in eval mode: per fc relu -> [node_norm] ->
    [BN] -> fc (no BN on the input; the embedding is pre-activation)."""
    for i in range(cfg["nlayers"] - 1):
        x = torch.relu(x)
        if cfg["node_norm"]:
            x = node_normalize(x)
        if cfg["use_bn"]:
            x = batch_norm_eval(x, p, i)
        x = mm(x, p[f"fcs.{i}.weight"].T, tf32) + p[f"fcs.{i}.bias"]
    return x


def embed(features: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each node's attr-value-weighted mean of its ids' table rows: X T /
    (row sums of X + 1e-10), ``features`` the sparse CSR [n, V]."""
    num = torch.sparse.mm(features, table)
    den = torch.sparse.sum(features.to_sparse_coo(), 1).to_dense()
    return num / (den[:, None] + 1e-10)


def blocks(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over row blocks of ``x``, concatenated."""
    return torch.cat([fn(x[i:i + BLOCK_ROWS])
                      for i in range(0, x.shape[0], BLOCK_ROWS)])


def predict_logits(cfg: dict, raw: dict, features, params: dict,
                   device, tf32: bool = False) -> torch.Tensor:
    """[n, C] logits of the whole graph: the dense engine propagates the
    features and classifies; the MAG engine embeds every node with
    ``params['table']``, propagates the embeddings and applies the head.
    ``features``: the dense [n, F] tensor as the request left it (dense
    engine; the MAG engine reads ``raw['features']``)."""
    with float32_matmuls(), torch.no_grad():
        op = operator(raw["adj"], device)
        if cfg["engine"] == "dense":
            x = features
            head = mlp_logits
        else:
            x = embed(_csr_tensor(raw["features"].tocsr(), device),
                      params["table"])
            head = mag_head
        prop = propagate(op, x, cfg["prop_mode"], cfg["order"], cfg["alpha"])
        del op, x
        return blocks(lambda b: head(b, params, cfg, tf32), prop)


def logit_gap(got, want: torch.Tensor) -> float:
    """max |got - want| / max |want| over every node and class."""
    got = torch.as_tensor(got, device=want.device)
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))
