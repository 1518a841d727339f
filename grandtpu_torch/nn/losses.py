"""Losses: supervised NLL + sharpened consistency regularization.

Port of ``grandtpu/nn/losses.py`` (reference ``model.py:123-140``): average
the K augmentations' probabilities, temperature-sharpen the average
(detached), then the per-augmentation L2 or KL distance to it, over rows
whose average max-prob exceeds the confidence threshold (2/n_class). An
empty confidence mask gives 0, not NaN (``PARITY.md`` divergence 1).
:func:`consis_loss_sharded` is the loss of a batch whose rows lie on the
shards of a mesh: the confidence test is per row, the count of confident
rows is the batch's.
"""

from __future__ import annotations

import torch


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood; labels are int class ids [B]."""
    return -log_probs.gather(-1, labels[:, None].long()).mean()


def consis_loss(log_prob_list: torch.Tensor, tem: float, conf: float,
                loss_kind: str = "l2",
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """log_prob_list: [K, U, C] log-softmax outputs on unlabeled rows.

    row_mask (optional [U] 0/1) drops wrap-padded duplicate rows from both
    the confidence mask and the mean.
    """
    total, count = _consis_terms(log_prob_list, tem, conf, loss_kind,
                                 row_mask)
    return total / count.clamp(min=1) / log_prob_list.shape[0]


def consis_loss_sharded(mesh, log_prob_lists: list, tem: float, conf: float,
                        loss_kind: str = "l2",
                        row_masks: list | None = None) -> torch.Tensor:
    """:func:`consis_loss` of the rows ``log_prob_lists[s]`` [K, U_s, C]
    of the mesh's shards make up, on the mesh's first device."""
    terms = [_consis_terms(lp, tem, conf, loss_kind,
                           None if row_masks is None else row_masks[s])
             for s, lp in enumerate(log_prob_lists)]
    total = mesh.reduce_sum([t for t, _ in terms])
    count = mesh.reduce_sum([c for _, c in terms])
    return total / count.clamp(min=1) / log_prob_lists[0].shape[0]


def _consis_terms(log_prob_list, tem, conf, loss_kind, row_mask):
    """(the distances summed over K and the confident rows, the count of
    confident rows)."""
    ps = log_prob_list.exp()                     # [K, U, C]
    avg_p = ps.mean(0)                           # [U, C]
    powed = avg_p.pow(1.0 / tem)
    sharp_p = (powed / powed.sum(-1, keepdim=True)).detach()

    mask = avg_p.max(-1).values > conf           # [U]
    if row_mask is not None:
        mask = mask & (row_mask > 0)

    if loss_kind == "kl":
        per_row = (-sharp_p[None] * log_prob_list).sum(-1)      # [K, U]
    elif loss_kind == "l2":
        per_row = ((ps - sharp_p[None]) ** 2).sum(-1)           # [K, U]
    else:
        raise ValueError(f"unknown consistency loss {loss_kind!r}")

    masked = torch.where(mask[None], per_row, 0.0)
    # mean over masked rows, then over K (reference sums per-k means / K)
    return masked.sum(), mask.sum()
