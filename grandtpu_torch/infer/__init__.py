"""Inference: exact full-graph propagation + chunked classification."""

from grandtpu_torch.infer.classify import predict_logits, test_accuracy  # noqa: F401
from grandtpu_torch.infer.propagate import Propagator, exact_propagate  # noqa: F401
