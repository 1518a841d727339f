"""Sparse containers: the padded top-k table and the CSR operator with its
SpMM hops (kernel K2 and its bf16 and int8 forms)."""

from grandtpu_torch.sparse.spmm import (CSROperator,  # noqa: F401
                                        quantize_columns,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8mxu)
from grandtpu_torch.sparse.topk import TopKProp  # noqa: F401
