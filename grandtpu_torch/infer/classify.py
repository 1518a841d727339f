"""Chunked full-graph classification after exact propagation (port of
``grandtpu/infer/classify.py``; reference ``model.py:169-178, 213-224`` and,
for the MAG model, ``model_mag.py:192-245``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from grandtpu_torch import observe
from grandtpu_torch.infer.propagate import exact_propagate
from grandtpu_torch.nn.sparse_input import embed_nodes


@torch.no_grad()
def predict_logits(model: nn.Module, feats: torch.Tensor,
                   batch_size: int = 10000) -> np.ndarray:
    """Logits of ``model`` (eval mode: BN on running stats) for every row of
    ``feats``, in chunks of ``batch_size`` rows; host numpy [n, C]. For the
    MAG model this is its head over propagated embeddings (``head_logits``
    in ``grandtpu``). bf16 rows (``bf16_carry`` propagation) are cast to
    f32 first, as JAX promotes them against the f32 weights. Spans:
    ``infer.classify``, around ``infer.classify.head`` (the chunks and
    their concatenation) and ``infer.classify.copy`` (to the host array,
    counting its ``copy_bytes``)."""
    model.eval()
    device = feats.device
    with observe.span("infer.classify", device=device):
        with observe.span("infer.classify.head", device=device):
            out = torch.cat([model(feats[i: i + batch_size].float())
                             for i in range(0, feats.shape[0], batch_size)])
        with observe.span("infer.classify.copy", device=device) as copy:
            out = out.cpu().numpy()
            copy.add("copy_bytes", out.nbytes)
    return out


head_logits = predict_logits


def test_accuracy(model: nn.Module, propagated_feats: torch.Tensor,
                  idx_test: np.ndarray, labels_int: np.ndarray,
                  batch_size: int = 10000) -> float:
    logits = predict_logits(model, propagated_feats, batch_size)
    preds = logits.argmax(axis=1)
    correct = np.equal(preds[idx_test], labels_int[idx_test]).sum()
    return float(correct) / len(idx_test)


@torch.no_grad()
def embed_all_nodes(table: torch.Tensor, attr_cols: torch.Tensor,
                    attr_vals: torch.Tensor,
                    batch_size: int = 10000) -> torch.Tensor:
    """All-node embeddings [n, H] on the table's device, ``batch_size``
    nodes per K3 node-form launch: the first phase of the MAG predict,
    split out so the caller can release the [n, P] attr tables before the
    propagation allocates its carries."""
    n = attr_cols.shape[0]
    with observe.span("infer.embed", device=table.device):
        embs = torch.empty((n, table.shape[1]), dtype=torch.float32,
                           device=table.device)
        for i in range(0, n, batch_size):
            embs[i: i + batch_size] = embed_nodes(
                table, attr_cols[i: i + batch_size],
                attr_vals[i: i + batch_size])
    return embs


def predict_logits_sparse(model: nn.Module, attr_cols, attr_vals, adj_sl, *,
                          mode: str = "ppr", order: int = 10,
                          alpha: float = 0.2, batch_size: int = 10000,
                          propagate=None,
                          precision: str = "f32") -> np.ndarray:
    """Full-graph logits of the MAG model: all-node embeddings in chunks ->
    exact propagation in embedding space -> head. It never forms a dense
    [n, vocab] matrix. ``attr_cols``/``attr_vals`` are the padded features
    [n, P] (arrays or tensors); everything runs on the model's device.
    ``propagate``: an optional override ``embs [n, H] -> propagated [n,
    H]`` in place of :func:`exact_propagate` (the row-partitioned mesh
    operator, say); ``precision``: that of :func:`exact_propagate` ('f32',
    'bf16', 'int8', 'auto', 'bf16_carry', ...) when it is not given. The
    whole call is the span ``infer.predict_sparse``, the root of the
    embedding's, the propagation's and the head's spans."""
    device = model.table.device
    with observe.span("infer.predict_sparse", device=device):
        embs = embed_all_nodes(model.table.detach(),
                               torch.as_tensor(attr_cols, device=device),
                               torch.as_tensor(attr_vals, device=device),
                               batch_size)
        if propagate is None:
            prop = exact_propagate(adj_sl, embs, mode=mode, order=order,
                                   alpha=alpha, precision=precision,
                                   device=device)
        else:
            prop = torch.as_tensor(propagate(embs), device=device)
        return head_logits(model, prop, batch_size)
