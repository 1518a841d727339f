"""Sparse-feature input path (MAG): embedding table + weighted mean (K3).

Port of ``grandtpu/nn/sparse_input.py`` (reference ``model_mag.py:21-55``).
Each node's representation is the attr-value-weighted mean of embedding
rows for its nonzero feature ids, with inverted input dropout on the
gathered rows. The denominator uses the undropped attr values, so unlike
DropNode the 1/(1-q) scale does not cancel.

Feature CSR rows are padded to an [N, P] block (:class:`PaddedFeatures`:
ids and values, padding value 0). The K3 op :func:`embed_prop` fuses that
embedding mean with the DropNode weighted mean over a batch's top-k rows,
as the MAG train step runs them (``grandtpu/train/trainer_sparse.py:46-84``):

    E[k,r,j]  = sum_p a * (drop ? drop[k,r,j,p] / (1-q) : 1) * T[c] / (sum_p a + 1e-10)
    out[k,r]  = sum_j w[k,r,j] * E[k,r,j] / (sum_j w[k,r,j] + 1e-12)

with ``c, a`` the attr ids and values of node ``tk_cols[r, j]`` and
``w = keep ? tk_vals : 0``. Without ``tk_cols`` (the node form) row r is
node r and ``out[k, r] = E[k, r]``: that is ``embed_nodes``. Gradients
flow into the table only. On CUDA tensors the forward and the backward
(a scatter-add into the table, each id's terms added in entry order: one
call into the kernel library, no sort) are the hand-written kernels of
``csrc/embed_prop.cu``; on CPU tensors :func:`embed_prop_plain` runs and
autograd gives the same gradient. :func:`embed_prop_backward_plain` is the
backward's plain version in the kernels' own order of operations.

:func:`embed_prop_window` is the same op over a vocab window: the table
holds the vocabulary's rows [lo, hi) (one shard of the vocab-sharded
table of data-parallel training), only the ids in the window add terms,
the denominator stays the whole row's attr mass, and the gradient is the
window's [hi - lo, H]. The windows' outputs sum to :func:`embed_prop`'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.ops._build import check, load_kernels

MAX_AUG = 8   # K values the kernels are instantiated for
MAX_SMEM = 232448   # shared memory an H100 block may take (227 KB)


@dataclasses.dataclass
class PaddedFeatures:
    """CSR features in padded-row layout. attr_cols/attr_vals: [N, P]."""
    attr_cols: np.ndarray
    attr_vals: np.ndarray
    num_features: int

    @staticmethod
    def from_csr(feats: sp.csr_matrix, cap: int | None = None
                 ) -> "PaddedFeatures":
        """Vectorised padded-row build (no per-row Python loop). With
        ``cap``, rows keep their ``cap`` largest-|value| entries."""
        feats = feats.tocsr()
        n = feats.shape[0]
        indptr = feats.indptr.astype(np.int64)
        nnz = np.diff(indptr)
        p_full = max(int(nnz.max()) if n else 1, 1)
        p = p_full if cap is None else max(min(p_full, int(cap)), 1)

        indices, data = feats.indices, feats.data
        if p < p_full:
            # rank entries within each row by |value| descending and keep
            # the first p: stable sort on (row, -|v|)
            rows_of = np.repeat(np.arange(n, dtype=np.int64), nnz)
            order = np.lexsort((-np.abs(data), rows_of))
            indices, data = indices[order], data[order]
            slot = np.arange(indices.shape[0]) - np.repeat(indptr[:-1], nnz)
            keep = slot < p
            indices, data = indices[keep], data[keep]
            nnz = np.minimum(nnz, p)
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(nnz, out=indptr[1:])

        slot = np.arange(indices.shape[0]) - np.repeat(indptr[:-1], nnz)
        rows_of = np.repeat(np.arange(n, dtype=np.int64), nnz)
        flat = rows_of * p + slot
        cols = np.zeros(n * p, dtype=np.int32)
        vals = np.zeros(n * p, dtype=np.float32)
        cols[flat] = indices
        vals[flat] = data
        return PaddedFeatures(cols.reshape(n, p), vals.reshape(n, p),
                              feats.shape[1])


def init_embedding(num_features: int, dim: int,
                   generator: torch.Generator) -> torch.Tensor:
    """torch ``nn.Embedding``'s default init, N(0, 1), drawn on the CPU."""
    return torch.randn(num_features, dim, generator=generator)


def embed_nodes_plain(table: torch.Tensor, attr_cols: torch.Tensor,
                      attr_vals: torch.Tensor, drop: torch.Tensor | None = None,
                      droprate: float = 0.0, vocab_lo: int = 0,
                      vocab_hi: int | None = None) -> torch.Tensor:
    """Weighted-mean embedding of padded attr rows [..., P] -> [..., H];
    ``drop`` (bool, broadcastable to [..., P, H], leading dims allowed) keeps
    gathered elements, scaled by 1/(1 - droprate). With ``vocab_hi``, the
    table holds the rows [vocab_lo, vocab_hi) and ids outside add 0."""
    if vocab_hi is None:
        e = table[attr_cols.long()]                      # [..., P, H]
    else:
        c = attr_cols.long() - vocab_lo
        inside = (c >= 0) & (c < vocab_hi - vocab_lo)
        e = torch.where(inside[..., None],
                        table[torch.where(inside, c, 0)], 0.0)
    if drop is not None:
        e = torch.where(drop, e / (1.0 - droprate), 0.0)
    num = torch.einsum("...p,...ph->...h",
                       attr_vals.expand(e.shape[:-1]), e)
    den = attr_vals.sum(-1, keepdim=True)
    return num / (den + 1e-10)


def _num_aug(keep, drop) -> int:
    if keep is not None:
        return keep.shape[0]
    return 1 if drop is None else drop.shape[0]


def embed_prop_plain(table: torch.Tensor, attr_cols: torch.Tensor,
                     attr_vals: torch.Tensor,
                     tk_cols: torch.Tensor | None = None,
                     tk_vals: torch.Tensor | None = None,
                     keep: torch.Tensor | None = None,
                     drop: torch.Tensor | None = None,
                     droprate: float = 0.0, vocab_lo: int = 0,
                     vocab_hi: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the K3 kernels (gather, mask, einsum means;
    differentiable in ``table``). Arguments as :func:`embed_prop`; with
    ``vocab_hi``, as :func:`embed_prop_window` (``table`` holds the rows
    [vocab_lo, vocab_hi))."""
    num_aug = _num_aug(keep, drop)
    win = {"vocab_lo": vocab_lo, "vocab_hi": vocab_hi}
    if tk_cols is None:
        e = embed_nodes_plain(table, attr_cols, attr_vals, drop, droprate,
                              **win)
        return e.expand(num_aug, *e.shape[-2:])          # [K, R, H]
    idx = tk_cols.long()
    e = embed_nodes_plain(table, attr_cols[idx], attr_vals[idx], drop,
                          droprate, **win)               # [(K,) R, Ktop, H]
    e = e.expand(num_aug, *e.shape[-3:])
    w = tk_vals[None] if keep is None else torch.where(keep, tk_vals[None],
                                                       0.0)
    w = w.expand(e.shape[:-1])
    num = torch.einsum("krj,krjh->krh", w, e)
    return num / (w.sum(-1, keepdim=True) + 1e-12)


def _check_args(table, attr_cols, attr_vals, tk_cols, tk_vals, keep, drop,
                droprate):
    """Validate the kernel's inputs; returns (rows, ktop, P, H, K)."""
    tensors = [t for t in (table, attr_cols, attr_vals, tk_cols, tk_vals,
                           keep, drop) if t is not None]
    if any(t.device != table.device for t in tensors):
        raise ValueError(f"embed_prop: all tensors must be on {table.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embed_prop: tensors must be contiguous")
    if (table.dtype != torch.float32 or attr_vals.dtype != torch.float32
            or attr_cols.dtype != torch.int32
            or (tk_cols is not None and tk_cols.dtype != torch.int32)
            or (tk_vals is not None and tk_vals.dtype != torch.float32)
            or (keep is not None and keep.dtype != torch.bool)
            or (drop is not None and drop.dtype != torch.bool)):
        raise TypeError("embed_prop wants an f32 table and values, int32 "
                        "ids and bool masks")
    if (table.dim() != 2 or attr_cols.dim() != 2
            or attr_vals.shape != attr_cols.shape):
        raise ValueError("embed_prop: table [V, H] and attr tables [N, P]")
    num_aug = _num_aug(keep, drop)
    p, h = attr_cols.shape[1], table.shape[1]
    if tk_cols is None:
        if tk_vals is not None or keep is not None:
            raise ValueError("embed_prop: the node form takes no tk_vals or "
                             "keep")
        rows, ktop, drop_shape = attr_cols.shape[0], 1, None
    else:
        if tk_vals is None or tk_cols.dim() != 2 or \
                tk_vals.shape != tk_cols.shape:
            raise ValueError("embed_prop: tk_cols and tk_vals must be "
                             "[R, Ktop]")
        rows, ktop = tk_cols.shape
        if keep is not None and keep.shape != (num_aug, rows, ktop):
            raise ValueError("embed_prop: keep must be [K, R, Ktop]")
        drop_shape = (num_aug, rows, ktop, p, h)
    if drop is not None:
        want = drop_shape or (num_aug, rows, p, h)
        if tuple(drop.shape) != want:
            raise ValueError(f"embed_prop: drop must be {want}")
        if not 0.0 <= droprate < 1.0:
            raise ValueError(f"embed_prop: droprate {droprate} not in [0, 1)")
    if not 1 <= num_aug <= MAX_AUG:
        raise ValueError(f"embed_prop: K={num_aug} outside 1..{MAX_AUG}")
    if fwd_smem_bytes(ktop, num_aug) > MAX_SMEM:
        raise ValueError(f"embed_prop: Ktop={ktop} too large for the "
                         "forward kernel's shared memory")
    return rows, ktop, p, h, num_aug


def fwd_smem_bytes(ktop: int, num_aug: int) -> int:
    """The most dynamic shared memory the K3 forward kernel takes at
    ``ktop`` and K (``csrc/embed_prop.cu``, ``fwd_config``): a warp a slot
    up to 32 warps a row, rows a block for 4 warps; each warp's partial sums
    of a 64-feature chunk, the rows' weights, and each warp's 384-byte id
    list."""
    wpr = min(ktop, 32)
    rpb = 1 if wpr >= 4 else -(-4 // wpr)
    warps = rpb * wpr
    return 4 * (warps * num_aug * 64 + rpb * num_aug * ktop) + warps * 384


def _ptr(t):
    return None if t is None else t.data_ptr()


class _EmbedProp(torch.autograd.Function):
    """The K3 forward kernel, with the K3 scatter-add kernel as backward;
    over the vocab window [lo, hi) when ``window`` is set (the window forms
    count their launches apart)."""

    @staticmethod
    def forward(ctx, table, attr_cols, attr_vals, tk_cols, tk_vals, keep,
                drop, droprate, dims, lo, hi, window):
        rows, ktop, p, h, num_aug = dims
        out = torch.empty((num_aug, rows, h), dtype=torch.float32,
                          device=table.device)
        if out.numel():
            rc = load_kernels().embed_prop_fwd_f32(
                table.data_ptr(), attr_cols.data_ptr(), attr_vals.data_ptr(),
                _ptr(tk_cols), _ptr(tk_vals), _ptr(keep), _ptr(drop),
                out.data_ptr(), rows, ktop, p, h, num_aug,
                1.0 - droprate, lo, hi,
                torch.cuda.current_stream(table.device).cuda_stream)
            check(rc, "embed_prop_fwd_f32")
            (embed_prop_window if window else embed_prop).launches += 1
        ctx.save_for_backward(attr_cols, attr_vals, tk_cols, tk_vals, keep,
                              drop)
        ctx.droprate, ctx.dims = droprate, dims
        ctx.lo, ctx.hi, ctx.window = lo, hi, window
        return out

    @staticmethod
    def backward(ctx, grad):
        args = ctx.saved_tensors + (ctx.droprate, ctx.dims)
        if ctx.window:
            d_table = embed_prop_window_backward(grad.contiguous(), ctx.lo,
                                                 ctx.hi, *args)
        else:
            d_table = embed_prop_backward(grad.contiguous(), ctx.hi, *args)
        return (d_table,) + (None,) * 11


def bwd_scratch_bytes(rows: int, ktop: int, p: int, h: int, num_aug: int,
                      drop: bool) -> int:
    """Bytes of the K3 backward's scratch (``csrc/embed_prop.cu``,
    ``carve_scratch``; ``embed_prop_bwd_scratch`` gives the kernels' own
    count): the S = rows x ktop slots' term vectors [S, NK, H] (NK = K with
    input dropout, else 1), four int32 or f32 arrays of the E = S x P
    entries, and four counters, each array padded to 16 bytes."""
    def pad4(n):
        return -(-n // 4) * 4

    slots = rows * ktop
    return 4 * (pad4(slots * (num_aug if drop else 1) * h)
                + 4 * pad4(slots * p) + 4)


def _launch_backward(counted, grad, lo, hi, attr_cols, attr_vals, tk_cols,
                     tk_vals, keep, drop, droprate, dims) -> torch.Tensor:
    rows, ktop, p, h, num_aug = dims
    if grad.shape != (num_aug, rows, h) or grad.dtype != torch.float32:
        raise ValueError(f"embed_prop_backward: grad must be f32 "
                         f"{(num_aug, rows, h)}")
    if rows * ktop * p >= 2 ** 31 - 1:
        raise ValueError(f"embed_prop_backward: {rows * ktop * p} entries, "
                         "past the kernels' int32 indices")
    # the kernels write every element of the gradient: zeros, or each id's
    # terms added in entry order (no float atomics, the same bits on every
    # run); the scratch's size follows from the shapes alone, so that a
    # CUDA graph can capture the call
    d_table = torch.empty((hi - lo, h), dtype=torch.float32,
                          device=grad.device)
    if not d_table.numel():
        return d_table
    scratch = torch.empty(
        bwd_scratch_bytes(rows, ktop, p, h, num_aug, drop is not None),
        dtype=torch.uint8, device=grad.device)
    check(load_kernels().embed_prop_bwd_f32(
        grad.data_ptr(), attr_cols.data_ptr(), attr_vals.data_ptr(),
        _ptr(tk_cols), _ptr(tk_vals), _ptr(keep), _ptr(drop),
        d_table.data_ptr(), scratch.data_ptr(), rows, ktop, p, h, num_aug,
        1.0 - droprate, lo, hi,
        torch.cuda.current_stream(grad.device).cuda_stream),
        "embed_prop_bwd_f32")
    counted.launches += 1
    return d_table


def _attr_mass_plain(a: torch.Tensor) -> torch.Tensor:
    """sum_p a over the last axis in the kernels' order (``attr_mass``):
    lane l of a warp adds p = l, l + 32, ... in turn from 0.0, then the
    lanes meet by a xor-shuffle tree."""
    lanes = a.new_zeros(*a.shape[:-1], 32)
    for p0 in range(0, a.shape[-1], 32):
        n = min(32, a.shape[-1] - p0)
        lanes[..., :n] = lanes[..., :n] + a[..., p0:p0 + n]
    idx = torch.arange(32, device=a.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def embed_prop_backward_plain(grad: torch.Tensor, vocab_lo: int,
                              vocab_hi: int, attr_cols: torch.Tensor,
                              attr_vals: torch.Tensor,
                              tk_cols: torch.Tensor | None = None,
                              tk_vals: torch.Tensor | None = None,
                              keep: torch.Tensor | None = None,
                              drop: torch.Tensor | None = None,
                              droprate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the K3 backward kernels, in their order of
    operations: the table gradient [hi - lo, H] of the vocab window
    [vocab_lo, vocab_hi) (0 and V for the whole table) given ``grad`` [K,
    R, H]. Each (row, slot, attribute) entry's term row is g / D * w / S *
    a (D summed serially over the slots, S in ``attr_mass``'s order; with
    input dropout each kept augmentation's share over keep_prob, added in k
    order), and each id's rows are added in entry order from 0.0, each
    operation rounded on its own: the kernels' bits. Other arguments as
    :func:`embed_prop`."""
    num_aug, rows, h = grad.shape
    dev = grad.device
    if tk_cols is None:                                  # node form
        node = torch.arange(rows, device=dev)[:, None]
        w = torch.ones(num_aug, rows, 1, device=dev)
        d = torch.ones(num_aug, rows, device=dev)
    else:
        node = tk_cols.long()
        w = (tk_vals.expand(num_aug, *tk_vals.shape) if keep is None
             else torch.where(keep, tk_vals, 0.0))
        d = torch.zeros(num_aug, rows, device=dev)
        for j in range(w.shape[-1]):                     # serially over j
            d = d + w[..., j]
        d = d + 1e-12
    a, c = attr_vals[node], attr_cols[node].long()       # [R, Ktop, P]
    s = _attr_mass_plain(a) + 1e-10                      # [R, Ktop]
    # dL/dnum of each slot's mean: g / D * w / S, per augmentation
    gn = grad[:, :, None] / d[..., None, None] * w[..., None] / s[..., None]
    if drop is None:
        tot = torch.zeros_like(gn[0])
        for k in range(num_aug):
            tot = tot + gn[k]
        term = tot[:, :, None] * a[..., None]            # [R, Ktop, P, H]
    else:
        gq = gn / torch.full_like(gn, 1.0 - droprate)
        kept = drop if tk_cols is not None else drop[:, :, None]
        v = torch.zeros(*a.shape, h, device=dev)
        for k in range(num_aug):
            v = torch.where(kept[k], v + gq[k][:, :, None], v)
        term = v * a[..., None]
    live = ((w != 0).any(0)[..., None] & (a != 0) & (c >= vocab_lo)
            & (c < vocab_hi)).reshape(-1)
    ids = c.reshape(-1)[live] - vocab_lo                 # in entry order
    rows_t = term.reshape(-1, h)[live]
    out = torch.zeros(vocab_hi - vocab_lo, h, device=dev)
    if not ids.numel():
        return out
    # each id's rows in entry order (a stable sort), the ids with the most
    # rows first, so that the ids still adding at step t are a prefix
    ids_s, perm = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids_s, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.sort(counts, descending=True, stable=True)[1]
    uniq, counts, starts = uniq[by_len], counts[by_len], starts[by_len]
    acc = torch.zeros(uniq.numel(), h, device=dev)
    n_at = torch.searchsorted(-counts, -torch.arange(
        1, int(counts[0]) + 1, device=dev), right=True).tolist()
    for t, n in enumerate(n_at):                         # counts > t: n ids
        acc[:n] = acc[:n] + rows_t[perm[starts[:n] + t]]
    out[uniq] = acc
    return out


def embed_prop_backward(grad: torch.Tensor, num_embeddings: int,
                        attr_cols, attr_vals, tk_cols, tk_vals, keep, drop,
                        droprate: float, dims) -> torch.Tensor:
    """The K3 backward kernels: the [V, H] table gradient, ``grad`` [K, R,
    H]'s terms scatter-added into zeros, each element's terms in entry
    order (the same bits on every run). On CPU tensors its plain version."""
    if grad.device.type == "cpu":
        return embed_prop_backward_plain(grad, 0, num_embeddings, attr_cols,
                                         attr_vals, tk_cols, tk_vals, keep,
                                         drop, droprate)
    if grad.device.type != "cuda":
        raise ValueError(f"unsupported device {grad.device}")
    return _launch_backward(embed_prop_backward, grad, 0, num_embeddings,
                            attr_cols, attr_vals, tk_cols, tk_vals, keep,
                            drop, droprate, dims)


def embed_prop_window_backward(grad: torch.Tensor, vocab_lo: int,
                               vocab_hi: int, attr_cols, attr_vals, tk_cols,
                               tk_vals, keep, drop, droprate: float,
                               dims) -> torch.Tensor:
    """The K3 backward kernels over the vocab window [vocab_lo, vocab_hi):
    the window's [hi - lo, H] gradient, ``grad``'s terms of in-window ids
    scatter-added into zeros. On CPU tensors its plain version."""
    if grad.device.type == "cpu":
        return embed_prop_backward_plain(grad, vocab_lo, vocab_hi, attr_cols,
                                         attr_vals, tk_cols, tk_vals, keep,
                                         drop, droprate)
    if grad.device.type != "cuda":
        raise ValueError(f"unsupported device {grad.device}")
    return _launch_backward(embed_prop_window_backward, grad, vocab_lo,
                            vocab_hi, attr_cols, attr_vals, tk_cols, tk_vals,
                            keep, drop, droprate, dims)


def embed_prop(table: torch.Tensor, attr_cols: torch.Tensor,
               attr_vals: torch.Tensor, tk_cols: torch.Tensor | None = None,
               tk_vals: torch.Tensor | None = None,
               keep: torch.Tensor | None = None,
               drop: torch.Tensor | None = None,
               droprate: float = 0.0) -> torch.Tensor:
    """K3: embedding mean + DropNode weighted mean -> [K, R, H].

    table [V, H] f32; attr_cols int32 / attr_vals f32 [N, P] (the padded
    features of every node, or of the R nodes themselves in the node form);
    tk_cols int32 / tk_vals f32 [R, Ktop] the batch's top-k rows, or None
    for the node form; keep [K, R, Ktop] bool (None: all kept); drop bool
    [K, R, Ktop, P, H] ([K, R, P, H] in the node form) or None when
    ``droprate`` is 0. K is keep's (else drop's) leading size, else 1.
    """
    if table.device.type == "cpu":
        return embed_prop_plain(table, attr_cols, attr_vals, tk_cols,
                                tk_vals, keep, drop, droprate)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dims = _check_args(table, attr_cols, attr_vals, tk_cols, tk_vals, keep,
                       drop, droprate)
    return _EmbedProp.apply(table, attr_cols, attr_vals, tk_cols, tk_vals,
                            keep, drop, droprate, dims, 0, table.shape[0],
                            False)


def embed_prop_window(table: torch.Tensor, vocab_lo: int, vocab_hi: int,
                      attr_cols: torch.Tensor, attr_vals: torch.Tensor,
                      tk_cols: torch.Tensor | None = None,
                      tk_vals: torch.Tensor | None = None,
                      keep: torch.Tensor | None = None,
                      drop: torch.Tensor | None = None,
                      droprate: float = 0.0) -> torch.Tensor:
    """K3 over the vocab window [vocab_lo, vocab_hi): ``table`` [hi - lo, H]
    holds those rows of the vocabulary; only attr ids inside the window
    add terms, the denominators are the full rows' (so the windows of a
    vocabulary sum to :func:`embed_prop`). Other arguments as
    :func:`embed_prop`; the gradient is the window's [hi - lo, H]."""
    if not (0 <= vocab_lo and vocab_hi - vocab_lo == table.shape[0]
            and vocab_hi < 2 ** 31):
        raise ValueError(f"embed_prop_window: the table's {table.shape[0]} "
                         f"rows are not the window [{vocab_lo}, {vocab_hi})")
    if table.device.type == "cpu":
        return embed_prop_plain(table, attr_cols, attr_vals, tk_cols,
                                tk_vals, keep, drop, droprate, vocab_lo,
                                vocab_hi)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dims = _check_args(table, attr_cols, attr_vals, tk_cols, tk_vals, keep,
                       drop, droprate)
    return _EmbedProp.apply(table, attr_cols, attr_vals, tk_cols, tk_vals,
                            keep, drop, droprate, dims, vocab_lo, vocab_hi,
                            True)


embed_prop.launches = 0
embed_prop_backward.launches = 0
embed_prop_window.launches = 0
embed_prop_window_backward.launches = 0


def embed_nodes(table: torch.Tensor, attr_cols: torch.Tensor,
                attr_vals: torch.Tensor) -> torch.Tensor:
    """Eval-mode ``embed_nodes`` of R nodes' padded rows [R, P] -> [R, H]
    (K3's node form)."""
    return embed_prop(table, attr_cols, attr_vals)[0]
