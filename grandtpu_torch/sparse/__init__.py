"""Sparse containers: the padded top-k table, the CSR operator with its
SpMM hops (kernel K2 and its bf16 and int8 forms) and the padded COO with
its segment SpMM (kernel K2-seg)."""

from grandtpu_torch.sparse.spmm import (CSROperator,  # noqa: F401
                                        PaddedCSR, column_absmax,
                                        quantize_columns,
                                        quantize_with_amax,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8mxu, spmm_segment)
from grandtpu_torch.sparse.topk import TopKProp  # noqa: F401
