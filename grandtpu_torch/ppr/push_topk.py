"""Per-row top-k of the GFPush device backends (``csrc/push_topk.cu``).

Port of the final selection of ``grandtpu/ppr/jax_push.py::_push_block``
(``lax.top_k``) and ``grandtpu/ppr/bucket_push.py::_finalize``: each row's k
largest values that are > 0, by value descending and, between equal values,
by id ascending, padded with col 0 and val 0. Rows are ragged: row r is
``vals[row_off[r]:row_off[r + 1]]`` with ids from ``ids`` (or the positions
in the row when ``ids`` is None).
"""

from __future__ import annotations

import torch

from grandtpu_torch.ops._build import check, load_kernels

MAX_K = 1024    # the kernel sorts the selected keys in shared memory


def row_offsets(counts: torch.Tensor) -> torch.Tensor:
    """int64 [R + 1] offsets of rows with ``counts`` [R] entries."""
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).long()


def push_topk_plain(ids, vals: torch.Tensor, row_off: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`push_topk`."""
    lens = row_off[1:] - row_off[:-1]
    rows = lens.numel()
    width = int(lens.max()) if rows else 0
    pos = torch.arange(width, device=vals.device)
    valid = pos[None] < lens[:, None]
    idx = torch.where(valid, row_off[:-1, None] + pos[None], 0)
    v = torch.where(valid, vals[idx], 0.0)
    v = torch.where(v > 0, v, 0.0)
    i = pos.expand(rows, width) if ids is None else ids[idx].long()
    # value descending, id ascending: a stable sort by id, then by value
    order = torch.argsort(i, dim=1, stable=True)
    i, v = i.gather(1, order), v.gather(1, order)
    order = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    i, v = i.gather(1, order), v.gather(1, order)
    keep = v > 0
    cols = torch.zeros((rows, k), dtype=torch.int32, device=vals.device)
    out = torch.zeros((rows, k), dtype=torch.float32, device=vals.device)
    cols[:, :i.shape[1]] = torch.where(keep, i, 0).int()
    out[:, :v.shape[1]] = torch.where(keep, v, 0.0)
    return cols, out


def push_topk(ids, vals: torch.Tensor, row_off: torch.Tensor, k: int):
    """Top-k of each row: (cols int32 [R, k], vals f32 [R, k]), R =
    ``row_off.numel() - 1``. ``vals`` f32 [T], ``ids`` int32 [T] or None,
    ``row_off`` int64 [R + 1], ``k`` <= :data:`MAX_K`."""
    if vals.device.type == "cpu":
        return push_topk_plain(ids, vals, row_off, k)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    tensors = [vals, row_off] + ([] if ids is None else [ids])
    if any(t.device != vals.device for t in tensors):
        raise ValueError(f"push_topk: all tensors must be on {vals.device}")
    if (vals.dtype != torch.float32 or row_off.dtype != torch.int64
            or (ids is not None and ids.dtype != torch.int32)):
        raise TypeError("push_topk wants f32 vals, int32 ids, int64 row_off")
    if not all(t.dim() == 1 and t.is_contiguous() for t in tensors):
        raise ValueError("push_topk: 1-D contiguous tensors")
    if ids is not None and ids.numel() != vals.numel():
        raise ValueError("push_topk: ids and vals differ in length")
    if not 0 < k <= MAX_K:
        raise ValueError(f"push_topk: k must be in 1..{MAX_K}")
    rows = row_off.numel() - 1
    cols = torch.empty((rows, k), dtype=torch.int32, device=vals.device)
    out = torch.empty((rows, k), dtype=torch.float32, device=vals.device)
    rc = load_kernels().push_topk(
        None if ids is None else ids.data_ptr(), vals.data_ptr(),
        row_off.data_ptr(), rows, k, cols.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream)
    check(rc, "push_topk")
    push_topk.launches += 1
    return cols, out


push_topk.launches = 0
