"""Chunked full-graph classification after exact propagation (port of
``grandtpu/infer/classify.py``; reference ``model.py:169-178, 213-224`` and,
for the MAG model, ``model_mag.py:192-245``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from grandtpu_torch import observe
from grandtpu_torch.infer.propagate import exact_propagate
from grandtpu_torch.nn import mlp_head
from grandtpu_torch.nn.sparse_input import embed_nodes


# the side stream a card device's logits are copied to the host on, made at
# first use: {device index: stream}
_COPY_STREAMS: dict = {}


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _COPY_STREAMS.get(index)
    if stream is None:
        stream = _COPY_STREAMS.setdefault(index, torch.cuda.Stream(index))
    return stream


@torch.no_grad()
def predict_logits(model: nn.Module, feats: torch.Tensor,
                   batch_size: int = 10000) -> np.ndarray:
    """Logits of ``model`` (eval mode: BN on running stats) for every row of
    ``feats``, in chunks of ``batch_size`` rows; host numpy [n, C]. For the
    MAG model this is its head over propagated embeddings (``head_logits``
    in ``grandtpu``). bf16 rows (``bf16_carry`` propagation) are cast to
    f32 first, as JAX promotes them against the f32 weights.

    On a card the result is one page-locked host array that the caller
    owns; PyTorch's caching host allocator takes its block back once the
    caller drops it and hands it to a later call, pinned already. Each
    chunk's copy into its rows runs on a side stream as soon as the chunk
    is ready, behind the next chunks' classifier, and the call returns
    once the last byte is on the host. Off a card the chunks are joined
    and copied to a new array.

    On a card each chunk goes through :func:`chunk_head`: the hand-written
    eval forward (``nn/mlp_head.py``) where it takes the model, else the
    model's own forward.

    Spans: ``infer.classify``, around ``infer.classify.head`` (the chunks;
    off a card also their concatenation; counting ``fused_rows``, the rows
    the hand-written head classified: all of them or none) and
    ``infer.classify.copy``
    (counting ``copy_bytes``, the host array's bytes). On a card the copy
    span's device time runs on the side stream, from the first chunk being
    ready to the last byte on the host, and it also counts
    ``pinned_bytes`` (the bytes copied asynchronously into page-locked
    memory) and ``copy_chunks``."""
    model.eval()
    device = feats.device
    with observe.span("infer.classify", device=device):
        if device.type == "cuda":
            return _chunks_to_host(model, feats, batch_size)
        with observe.span("infer.classify.head", device=device) as head:
            out = torch.cat([model(feats[i: i + batch_size].float())
                             for i in range(0, feats.shape[0], batch_size)])
            head.add("fused_rows", 0)
        with observe.span("infer.classify.copy", device=device) as copy:
            out = out.cpu().numpy()
            copy.add("copy_bytes", out.nbytes)
    return out


def chunk_head(model: nn.Module, device: torch.device):
    """(the function ``run(x, _after_head=False)`` that ``predict_logits``
    applies on a card to each chunk ``x`` of f32 rows on ``device``, whether
    it is the hand-written eval forward): that kernel
    (``mlp_head.head_launcher``) where it takes ``model``, has room for its
    widths and the model is on ``device``, else the model's forward
    (``_after_head`` unused)."""
    if (mlp_head.takes(model) and model.fcs[0].weight.device == device
            and mlp_head.fits(model)):
        launch = mlp_head.head_launcher(model)
        return (lambda x, _after_head=False:
                launch(x.contiguous(), _after_head)), True
    return (lambda x, _after_head=False: model(x)), False


def _chunks_to_host(model: nn.Module, feats: torch.Tensor,
                    batch_size: int) -> np.ndarray:
    """``predict_logits`` on a card: the head's chunks on the current
    stream, each copied by the side stream into its rows of one pinned
    host tensor once an event says it is ready."""
    device = feats.device
    compute, side = torch.cuda.current_stream(device), _copy_stream(device)
    chunks, ready = [], []
    run, fused = chunk_head(model, device)
    # f32 rows take no conversion between the chunks' launches, so each
    # launch after the first may overlap the one before it
    overlap = feats.dtype == torch.float32 and feats.is_contiguous()
    with observe.span("infer.classify.head", device=device) as head:
        for n, i in enumerate(range(0, feats.shape[0], batch_size)):
            chunks.append(run(feats[i: i + batch_size].float(),
                              _after_head=overlap and n > 0))
            ready.append(compute.record_event())
        head.add("fused_rows", feats.shape[0] if fused else 0)
    # outside the head's span: where the host paces the head, a new block's
    # pinning (0.1 s for 0.5 GB on an H100's host) would stall inside it
    host = torch.empty((feats.shape[0],) + chunks[0].shape[1:],
                       dtype=chunks[0].dtype, pin_memory=True)
    with torch.cuda.stream(side):
        side.wait_event(ready[0])
        with observe.span("infer.classify.copy", device=device) as copy:
            row = 0
            for y, event in zip(chunks, ready):
                side.wait_event(event)
                host[row: row + y.shape[0]].copy_(y, non_blocking=True)
                row += y.shape[0]
            copy.add("copy_bytes", host.nbytes)
            copy.add("pinned_bytes", host.nbytes if host.is_pinned() else 0)
            copy.add("copy_chunks", len(chunks))
        done = side.record_event()
    # the chunks stay referenced until their copies are done
    done.synchronize()
    return host.numpy()


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
