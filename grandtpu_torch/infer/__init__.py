"""Inference: exact full-graph propagation + chunked classification."""

from grandtpu_torch.infer.classify import (embed_all_nodes,  # noqa: F401
                                           head_logits, predict_logits,
                                           predict_logits_sparse,
                                           test_accuracy)
from grandtpu_torch.infer.propagate import (Propagator,  # noqa: F401
                                            choose_fast_precision,
                                            exact_propagate,
                                            exact_propagator)
