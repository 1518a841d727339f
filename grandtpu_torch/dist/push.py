"""GFPush with the sources sharded over a mesh or over processes (port of
``grandtpu/dist/push.py``, D2).

The precompute is embarrassingly parallel over source nodes:

- :func:`sharded_gfpush`: the dense-residue push (P1,
  ``ppr/dense_push.py``) over the port's mesh: the graph replicated (one
  copy per distinct device), the sources padded with node 0 and split
  over the shards, no communication until the tables are gathered in
  source order (on a mesh over processes, on every rank);
- :func:`push_source_shard`: the pure per-rank unit, a rank's contiguous
  share of the sources through :func:`grandtpu_torch.ppr.gfpush`;
- :func:`multihost_native_gfpush`: every ``torch.distributed`` rank
  pushes its share with ``push_source_shard``, then one all-gather of the
  padded [per, k] tables gives every rank the whole table: n_src k 8
  bytes in all, whatever the graph's size. The tables are host arrays:
  under gloo they move on the host, under NCCL (which takes card tensors
  only) through each rank's card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from grandtpu_torch.dist.mesh import Mesh, all_gather_tensor
from grandtpu_torch.ppr.dense_push import DensePushGraph, push_block
from grandtpu_torch.sparse.topk import TopKProp


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
    for s, g in zip(mesh.shards, graphs):
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


def multihost_native_gfpush(adj, sources: np.ndarray, *,
                            prop_mode: str = "ppr", order: int = 10,
                            alpha: float = 0.2, rmax: float = 1e-7,
                            k: int = 32, num_threads: int = 0,
                            backend: str = "native",
                            device="cuda") -> TopKProp:
    """GFPush with ``sources`` sharded over the ``torch.distributed`` ranks
    (the plain :func:`~grandtpu_torch.ppr.gfpush` without a process group
    of more than one rank). ``backend``: each rank's push ('native', the
    host C++ kernel, by default; a device backend pushes on ``device``).
    Every rank returns the whole table, equal to one process's push."""
    sources = np.asarray(sources)
    world, rank = 1, 0
    if tdist.is_available() and tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
    lo, hi, cols, vals = push_source_shard(
        adj, sources, rank, world, prop_mode=prop_mode, order=order,
        alpha=alpha, rmax=rmax, k=k, backend=backend,
        num_threads=num_threads, device=device)
    if world == 1:
        return TopKProp(sources, cols, vals, adj.shape[0])
    per = -(-sources.shape[0] // world)
    cols_p = np.zeros((per, k), np.int32)
    vals_p = np.zeros((per, k), np.float32)
    cols_p[: hi - lo], vals_p[: hi - lo] = cols, vals
    full = [torch.cat(all_gather_tensor(torch.from_numpy(a))).numpy()
            [: sources.shape[0]] for a in (cols_p, vals_p)]
    return TopKProp(sources, *full, adj.shape[0])
