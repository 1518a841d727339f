"""Chunked full-graph classification after exact propagation (port of
``grandtpu/infer/classify.py``; reference ``model.py:169-178, 213-224``)."""

from __future__ import annotations

import numpy as np
import torch

from grandtpu_torch.nn.mlp import MLP


@torch.no_grad()
def predict_logits(model: MLP, feats: torch.Tensor,
                   batch_size: int = 10000) -> np.ndarray:
    """MLP logits (eval mode: BN on running stats) for every row of
    ``feats``, in chunks of ``batch_size`` rows; host numpy [n, C]."""
    model.eval()
    out = [model(feats[i: i + batch_size])
           for i in range(0, feats.shape[0], batch_size)]
    return torch.cat(out).cpu().numpy()


def test_accuracy(model: MLP, propagated_feats: torch.Tensor,
                  idx_test: np.ndarray, labels_int: np.ndarray,
                  batch_size: int = 10000) -> float:
    logits = predict_logits(model, propagated_feats, batch_size)
    preds = logits.argmax(axis=1)
    correct = np.equal(preds[idx_test], labels_int[idx_test]).sum()
    return float(correct) / len(idx_test)
