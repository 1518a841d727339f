"""Dense-residue batched GFPush (P1), the port of
``grandtpu/ppr/jax_push.py``, reached by ``gfpush(backend="jax")``.

A block of B sources carries dense residue and reserve carries, node-major
[n, B] (so that K2 takes them as they are). Each hop is grandtpu's

    reserve += coef[i] * residue
    teleport = sum of the residues on dangling nodes
    pushed   = residue >= rmax*deg and residue > 0 ? residue / deg : 0
    residue  = A^T @ pushed   (+ teleport at each source's own row)

with the elementwise part in one kernel (:func:`dense_push_mask`,
``csrc/push_dense.cu``; the teleport is added in the next hop's call) and
the product as K2 over the CSR of A^T with unit values
(:func:`~grandtpu_torch.sparse.spmm.spmm_prop_step`), or as an f32
``torch.matmul`` with A^T dense for n <= ``dense_threshold``, where grandtpu
takes ``jnp.dot`` outside any kernel. TF32 is off for it, as in ``train()``.
The reserve is then transposed to [B, n] (one coalesced copy, so the
top-k's CTA of a row reads it contiguously) and :func:`push_topk` keeps k.
The teleport sums are taken in 62-bit fixed point (exact, the same in any
order); grandtpu sums in f32.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.device import resolve_device
from grandtpu_torch.ops._build import check, load_kernels
from grandtpu_torch.ppr.bucket_push import ONE
from grandtpu_torch.ppr.push_topk import push_topk, push_topk_plain
from grandtpu_torch.sparse.spmm import (CSROperator, spmm_prop_step,
                                        spmm_prop_step_plain)


def dense_push_mask_plain(residue, reserve, pushed, tele_in, tele_out, src,
                          deg, thr, coef: float, final: bool) -> None:
    """Plain PyTorch version of :func:`dense_push_mask`."""
    r = residue
    if tele_in is not None:
        r = residue.clone()
        b = torch.arange(r.shape[1], device=r.device)
        r[src.long(), b] += (tele_in.double() / ONE).float()
    reserve += r * coef
    if final:
        return
    dangling = (deg == 0)[:, None]
    tele_out.copy_(torch.where(dangling & (r > 0), r.double() * ONE, 0.0)
                   .long().sum(0))
    mask = (r >= thr[:, None]) & (r > 0) & ~dangling
    safe = torch.where(deg == 0, 1.0, deg)[:, None]
    pushed.copy_(torch.where(mask, r / safe, 0.0))


def dense_push_mask(residue: torch.Tensor, reserve: torch.Tensor,
                    pushed: torch.Tensor, tele_in, tele_out, src: torch.Tensor,
                    deg: torch.Tensor, thr: torch.Tensor, coef: float,
                    final: bool) -> None:
    """One hop's push mask, in place: ``residue`` [n, B] f32 (read),
    ``reserve`` (updated), ``pushed`` (written); ``tele_in`` [B] int64 Q62,
    the previous hop's teleport, added at (src[b], b) (None on the first
    hop); ``tele_out`` [B] int64, zeroed by the caller, gets this hop's
    (unused when ``final``); ``src`` [B] int32; ``deg``, ``thr`` [n] f32.
    ``coef`` must be an f32 value."""
    if residue.device.type == "cpu":
        dense_push_mask_plain(residue, reserve, pushed, tele_in, tele_out,
                              src, deg, thr, coef, final)
        return
    if residue.device.type != "cuda":
        raise ValueError(f"unsupported device {residue.device}")
    n, b = residue.shape
    carries = [residue, reserve, pushed]
    vecs = [deg, thr] + [t for t in (tele_in, tele_out) if t is not None]
    tensors = carries + vecs + [src]
    if any(t.device != residue.device for t in tensors):
        raise ValueError(f"dense_push_mask: all tensors must be on "
                         f"{residue.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_push_mask: tensors must be contiguous")
    if (any(t.dtype != torch.float32 for t in carries + [deg, thr])
            or src.dtype != torch.int32
            or any(t.dtype != torch.int64 for t in vecs[2:])):
        raise TypeError("dense_push_mask wants f32 carries, deg and thr, "
                        "int32 src and int64 teleports")
    if (any(t.shape != (n, b) for t in carries) or deg.shape != (n,)
            or thr.shape != (n,)
            or any(t.shape != (b,) for t in vecs[2:] + [src])):
        raise ValueError(f"dense_push_mask: carries must be [{n}, {b}]")
    if tele_out is None and not final:
        raise ValueError("dense_push_mask: tele_out is needed but final")
    rc = load_kernels().dense_push_mask(
        residue.data_ptr(), reserve.data_ptr(), pushed.data_ptr(),
        None if tele_in is None else tele_in.data_ptr(),
        None if tele_out is None else tele_out.data_ptr(), src.data_ptr(),
        deg.data_ptr(), thr.data_ptr(), n, b, float(coef), int(final),
        torch.cuda.current_stream(residue.device).cuda_stream)
    check(rc, "dense_push_mask")
    dense_push_mask.launches += 1


dense_push_mask.launches = 0


class DensePushGraph:
    """The operand of P1's product on a device, with the degrees and the
    rmax thresholds (f32 ``rmax * deg``, as grandtpu computes them)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, rmax: float,
                 dense_threshold: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        indptr = np.asarray(indptr, np.int32)
        indices = np.asarray(indices, np.int32)
        self.n = n = indptr.shape[0] - 1
        deg = (indptr[1:] - indptr[:-1]).astype(np.float32)
        self.deg = torch.as_tensor(deg, device=self.device)
        self.thr = torch.as_tensor(np.float32(rmax) * deg, device=self.device)
        # structure only, as the oracle: A^T with unit values
        a_t = sp.csr_matrix((np.ones(indices.shape[0], np.float32), indices,
                             indptr), shape=(n, n)).T.tocsr()
        self.use_dense = n <= dense_threshold
        if self.use_dense:
            self.a_t = torch.as_tensor(a_t.toarray(), device=self.device)
        else:
            self.op_t = CSROperator.from_scipy(a_t, self.device)

    def product(self, pushed: torch.Tensor, residue: torch.Tensor,
                plain: bool = False) -> None:
        """``residue = A^T @ pushed`` (both [n, B] f32)."""
        if self.use_dense:
            torch.matmul(self.a_t, pushed, out=residue)
        else:
            (spmm_prop_step_plain if plain else spmm_prop_step)(
                self.op_t, pushed, residue, None, 1.0, False)


def push_block(g: DensePushGraph, src: torch.Tensor, coef: np.ndarray,
               k: int, plain: bool = False):
    """P1 for the sources ``src`` (int32 [B] on ``g.device``): (cols int32
    [B, k], vals f32 [B, k]) on the device. ``plain`` runs the plain
    versions on any device."""
    mask = dense_push_mask_plain if plain else dense_push_mask
    topk = push_topk_plain if plain else push_topk
    n, b = g.n, src.shape[0]
    residue = torch.zeros((n, b), device=g.device)
    residue[src.long(), torch.arange(b, device=g.device)] = 1.0
    reserve = torch.zeros_like(residue)
    pushed = torch.empty_like(residue)
    tele_in = None
    n_hops = coef.shape[0] - 1
    for i in range(n_hops):
        tele_out = torch.zeros(b, dtype=torch.int64, device=g.device)
        mask(residue, reserve, pushed, tele_in, tele_out, src, g.deg, g.thr,
             float(coef[i]), False)
        g.product(pushed, residue, plain)
        tele_in = tele_out
    mask(residue, reserve, pushed, tele_in, None, src, g.deg, g.thr,
         float(coef[n_hops]), True)
    del residue, pushed
    rows = reserve.t().contiguous().reshape(-1)
    off = torch.arange(b + 1, device=g.device, dtype=torch.int64) * n
    return topk(None, rows, off, k)


def gfpush_dense(indptr: np.ndarray, indices: np.ndarray, sources: np.ndarray,
                 coef: np.ndarray, rmax: float, k: int, block: int = 512,
                 dense_threshold: int = 8192, device="cuda"):
    """Run the dense-residue push over all sources in blocks of ``block`` on
    ``device``. Returns numpy (cols int32 [n_src, k], vals float32
    [n_src, k]), rows sorted descending, as ``gfpush_jax``."""
    g = DensePushGraph(indptr, indices, rmax, dense_threshold, device)
    if g.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    coef = np.asarray(coef, np.float32)
    sources = np.asarray(sources, np.int32)
    n_src = sources.shape[0]
    out_cols = np.zeros((n_src, k), np.int32)
    out_vals = np.zeros((n_src, k), np.float32)
    for start in range(0, n_src, block):
        sl = slice(start, min(start + block, n_src))
        src = torch.as_tensor(sources[sl], device=g.device)
        cols, vals = push_block(g, src, coef, k)
        out_cols[sl] = cols.cpu().numpy()
        out_vals[sl] = vals.cpu().numpy()
    return out_cols, out_vals
