"""CSR SpMM with the fused power-iteration update (K2).

Port of the math of ``grandtpu/sparse/spmm.py`` (``spmm_split`` /
``spmm_block`` / ``spmm_block_offset``): ``y = A @ x`` for the row-
normalized propagation operator ``A = D^-1 (adj + I)``. The TPU's SplitCSR
one-hot-matmul layout is not carried over; the operator is plain CSR on
the device. One :func:`spmm_prop_step` is one hop of the power iteration
in ``grandtpu/infer/propagate.py`` with its update fused in:

    cur_out = scale * (A @ cur_in);   acc += cur_out  (if accumulate)

On CUDA tensors it launches ``csrc/csr_spmm.cu``; on CPU tensors it runs
:func:`spmm_prop_step_plain`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from grandtpu_torch.ops._build import check, load_kernels


@dataclasses.dataclass
class CSROperator:
    """A square CSR matrix on a device: int32 structure, f32 values."""
    indptr: torch.Tensor      # int32 [n + 1]
    indices: torch.Tensor     # int32 [nnz]
    values: torch.Tensor      # f32 [nnz]
    num_rows: int

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
            num_rows=mat.shape[0])


def spmm_prop_step_plain(op: CSROperator, cur_in: torch.Tensor,
                         cur_out: torch.Tensor, acc: torch.Tensor | None,
                         scale: float, accumulate: bool) -> None:
    """Plain PyTorch version of the kernel (gather, scale, index_add_)."""
    counts = op.indptr[1:].long() - op.indptr[:-1].long()
    rows = torch.repeat_interleave(
        torch.arange(op.num_rows, device=cur_in.device), counts)
    prod = cur_in[op.indices.long()] * op.values[:, None]
    y = torch.zeros_like(cur_out).index_add_(0, rows, prod)
    torch.mul(y, scale, out=cur_out)
    if accumulate:
        acc.add_(cur_out)


def spmm_prop_step(op: CSROperator, cur_in: torch.Tensor,
                   cur_out: torch.Tensor, acc: torch.Tensor | None,
                   scale: float, accumulate: bool) -> None:
    """One hop: ``cur_out = scale * (op @ cur_in)``, then ``acc += cur_out``
    if ``accumulate``. Writes ``cur_out`` (and ``acc``) in place; the
    caller swaps ``cur_in`` and ``cur_out`` between hops. All [n, F] f32,
    contiguous, ``cur_in`` not aliasing ``cur_out``."""
    if cur_in.device.type == "cpu":
        spmm_prop_step_plain(op, cur_in, cur_out, acc, scale, accumulate)
        return
    if cur_in.device.type != "cuda":
        raise ValueError(f"unsupported device {cur_in.device}")
    dense = [cur_in, cur_out] + ([acc] if accumulate else [])
    tensors = dense + [op.indptr, op.indices, op.values]
    if any(t.device != cur_in.device for t in tensors):
        raise ValueError(f"spmm_prop_step: all tensors must be on "
                         f"{cur_in.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmm_prop_step: tensors must be contiguous")
    if (any(t.dtype != torch.float32 for t in dense + [op.values])
            or op.indptr.dtype != torch.int32
            or op.indices.dtype != torch.int32):
        raise TypeError("spmm_prop_step wants f32 values and carries and "
                        "int32 indptr/indices")
    shape = (op.num_rows, cur_in.shape[1])
    if any(tuple(t.shape) != shape for t in dense):
        raise ValueError(f"spmm_prop_step: carries must be {shape}")
    if cur_out.numel() == 0:      # nothing to launch
        return
    if cur_in.data_ptr() == cur_out.data_ptr():
        raise ValueError("spmm_prop_step: cur_in and cur_out must differ")
    lib = load_kernels()
    rc = lib.csr_spmm_prop_f32(
        op.indptr.data_ptr(), op.indices.data_ptr(), op.values.data_ptr(),
        cur_in.data_ptr(), cur_out.data_ptr(),
        acc.data_ptr() if accumulate else None,
        shape[0], shape[1], float(scale), int(accumulate),
        torch.cuda.current_stream(cur_in.device).cuda_stream)
    check(rc, "csr_spmm_prop_f32")
    spmm_prop_step.launches += 1


spmm_prop_step.launches = 0
