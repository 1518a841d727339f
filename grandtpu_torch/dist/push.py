"""GFPush with the sources sharded over a mesh (port of
``grandtpu/dist/push.py``, D2).

The precompute is embarrassingly parallel over source nodes:

- :func:`sharded_gfpush`: the dense-residue push (P1,
  ``ppr/dense_push.py``) over the port's mesh: the graph replicated (one
  copy per distinct device), the sources padded with node 0 and split
  over the shards, no communication until the tables are gathered in
  source order;
- :func:`push_source_shard`: the pure per-rank unit, a rank's contiguous
  share of the sources through :func:`grandtpu_torch.ppr.gfpush`.

grandtpu's ``multihost_native_gfpush`` needs a mesh over processes
(ROADMAP Queue A 8).
"""

from __future__ import annotations

import numpy as np
import torch

from grandtpu_torch.dist.mesh import Mesh
from grandtpu_torch.ppr.dense_push import DensePushGraph, push_block


def sharded_gfpush(mesh: Mesh, indptr: np.ndarray, indices: np.ndarray,
                   sources: np.ndarray, coef: np.ndarray, rmax: float,
                   k: int, *, axis: str = "data",
                   dense_threshold: int = 8192, block: int = 512):
    """GFPush with ``sources`` sharded over ``mesh``'s axis ``axis``: each
    shard runs P1 over its contiguous share, ``block`` sources a
    ``push_block`` call (which bounds its [n, block] carries; every
    source's row is the same in any block). Returns numpy (cols int32
    [n_src, k], vals float32 [n_src, k]), as ``gfpush_jax``."""
    if axis != "data":
        raise ValueError(f"the port's mesh has the axis 'data' only, not "
                         f"{axis!r}")
    graphs = mesh.per_device(lambda d: DensePushGraph(
        indptr, indices, rmax, dense_threshold, d))
    if any(g.device.type == "cuda" for g in graphs):
        torch.backends.cuda.matmul.allow_tf32 = False
    coef = np.asarray(coef, np.float32)
    n_src = sources.shape[0]
    per = -(-n_src // mesh.size)
    # the pad pushes from node 0 and is sliced off
    src_pad = np.zeros(per * mesh.size, np.int32)
    src_pad[:n_src] = sources
    cols, vals = [], []
    for s, g in enumerate(graphs):
        src = torch.as_tensor(src_pad[s * per:(s + 1) * per], device=g.device)
        outs = [push_block(g, src[i:i + block], coef, k)
                for i in range(0, per, block)]
        cols.append(torch.cat([c for c, _ in outs]))
        vals.append(torch.cat([v for _, v in outs]))
    return (mesh.gather_rows(cols)[:n_src].cpu().numpy(),
            mesh.gather_rows(vals)[:n_src].cpu().numpy())


def push_source_shard(adj, sources: np.ndarray, rank: int, world: int, *,
                      prop_mode: str = "ppr", order: int = 10,
                      alpha: float = 0.2, rmax: float = 1e-7, k: int = 32,
                      backend: str = "native", num_threads: int = 0,
                      device="cuda"):
    """GFPush of rank ``rank``'s contiguous share of ``sources`` among
    ``world`` ranks (the unit a multi-process push runs on each rank;
    callable alone to emulate any world size). Returns (lo, hi, cols
    [hi - lo, k], vals [hi - lo, k])."""
    from grandtpu_torch.ppr import gfpush

    n_src = sources.shape[0]
    per = -(-n_src // world)
    lo, hi = rank * per, min((rank + 1) * per, n_src)
    if lo >= hi:
        return lo, lo, np.zeros((0, k), np.int32), np.zeros((0, k),
                                                            np.float32)
    tk = gfpush(adj, sources[lo:hi], prop_mode=prop_mode, order=order,
                alpha=alpha, rmax=rmax, k=k, backend=backend,
                num_threads=num_threads, device=device)
    return lo, hi, tk.cols, tk.vals
