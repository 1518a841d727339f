"""Losses: supervised NLL + sharpened consistency regularization.

Port of ``grandtpu/nn/losses.py`` (reference ``model.py:123-140``): average
the K augmentations' probabilities, temperature-sharpen the average
(detached), then the per-augmentation L2 or KL distance to it, over rows
whose average max-prob exceeds the confidence threshold (2/n_class). An
empty confidence mask gives 0, not NaN (``PARITY.md`` divergence 1).
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
    ps = log_prob_list.exp()                     # [K, U, C]
    avg_p = ps.mean(0)                           # [U, C]
    powed = avg_p.pow(1.0 / tem)
    sharp_p = (powed / powed.sum(-1, keepdim=True)).detach()

    mask = avg_p.max(-1).values > conf           # [U]
    if row_mask is not None:
        mask = mask & (row_mask > 0)
    denom = mask.sum().clamp(min=1)

    if loss_kind == "kl":
        per_row = (-sharp_p[None] * log_prob_list).sum(-1)      # [K, U]
    elif loss_kind == "l2":
        per_row = ((ps - sharp_p[None]) ** 2).sum(-1)           # [K, U]
    else:
        raise ValueError(f"unknown consistency loss {loss_kind!r}")

    masked = torch.where(mask[None], per_row, 0.0)
    # mean over masked rows, then over K (reference sums per-k means / K)
    return masked.sum() / denom / log_prob_list.shape[0]
