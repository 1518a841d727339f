"""Sparse containers: the padded top-k table and the CSR operator with its
SpMM (kernel K2)."""

from grandtpu_torch.sparse.spmm import CSROperator, spmm_prop_step  # noqa: F401
from grandtpu_torch.sparse.topk import TopKProp  # noqa: F401
