"""Train and eval steps (port of ``grandtpu/train/step.py``).

One training step is the reference inner loop (``model.py:303-334``):

    keep ~ Bernoulli(1 - p) per (k, row, slot), drawn from the generator
    x = K1(features, cols, vals, keep)        [K, B, F], no gradient
    for k in 1..K:  MLP(x[k]) -> log_softmax   (BN running stats update in
                                               order: K sequential updates)
    loss = mean_k masked NLL + ramp * consis_loss
    grad norm (always measured) -> [clip] -> Adam with coupled L2

Batches are wrap-padded to a fixed size; the masks weight the padding out
of the NLL, the BN statistics and the consistency loss, so a padded step
equals a step on the true smaller batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from grandtpu_torch.nn.dropnode import gather_and_prop
from grandtpu_torch.nn.losses import consis_loss
from grandtpu_torch.nn.mlp import MLP, MLPConfig


@dataclasses.dataclass(frozen=True)
class StepConfig:
    mlp: MLPConfig
    k_aug: int                  # K augmentations (reference --sample)
    dropnode_rate: float
    n_train: int                # labeled rows per batch (batch_size)
    lam: float
    warmup: float
    tem: float
    conf: float
    loss_kind: str              # 'l2' | 'kl'
    clip_norm: float            # <=0 disables


def make_optimizer(model: MLP, lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: coupled weight decay added to the (clipped)
    gradient before the moments, betas (0.9, 0.999), eps 1e-8 — the same
    as ``grandtpu``'s ``make_optimizer`` (reference ``model.py:288-289``)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def _masked_nll(logps_k, labels, mask):
    """Mean over K augs of masked-mean NLL. logps_k [K, B, C]."""
    picked = logps_k.gather(
        -1, labels[None, :, None].expand(logps_k.shape[0], -1, 1))[..., 0]
    per_k = -(picked * mask[None]).sum(-1) / mask.sum().clamp(min=1.0)
    return per_k.mean()


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def _clip_(grads, gnorm: torch.Tensor, clip_norm: float) -> None:
    """Scale ``grads`` in place by min(1, clip_norm / (gnorm + 1e-6))."""
    scale = (clip_norm / (gnorm + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)


def _eval_metrics(logps, labels, mask):
    """(masked mean NLL, masked accuracy) of log-probs [B, C]."""
    picked = logps.gather(-1, labels[:, None])[:, 0]
    denom = mask.sum().clamp(min=1.0)
    nll = -(picked * mask).sum() / denom
    acc = ((logps.argmax(-1) == labels) * mask).sum() / denom
    return nll, acc


def build_train_step(cfg: StepConfig, model: MLP,
                     optimizer: torch.optim.Optimizer) -> Callable:
    """Returns step(features, tk_cols, tk_vals, batch, generator, num_batch)
    -> metrics (0-d tensors), updating ``model`` and ``optimizer`` in place.

    batch = dict(rows [B] positions into the top-k table, labels [n_train],
    label_mask [n_train] f32, optional unlabel_mask [B - n_train] f32), all
    on the features' device; B = n_train + n_unlabeled.
    """
    params = list(model.parameters())

    def step(features, tk_cols, tk_vals, batch, generator, num_batch):
        model.train()
        cols = tk_cols[batch["rows"]]                        # [B, Ktop]
        vals = tk_vals[batch["rows"]]
        nt = cfg.n_train
        um = batch.get("unlabel_mask")
        if um is None:
            um = torch.ones(cols.shape[0] - nt, device=cols.device)
        bmask = torch.cat([batch["label_mask"], um])
        keep = torch.rand((cfg.k_aug, *cols.shape), generator=generator,
                          device=cols.device) < 1.0 - cfg.dropnode_rate
        # the augmentation carries no gradient (reference detaches it)
        x = gather_and_prop(features, cols, vals, keep)      # [K, B, F]
        logps = torch.stack([
            torch.log_softmax(model(x[k], batch_mask=bmask
                                    if cfg.mlp.use_bn else None,
                                    generator=generator), dim=-1)
            for k in range(cfg.k_aug)])
        labels, lmask = batch["labels"], batch["label_mask"]
        sup = _masked_nll(logps[:, :nt], labels, lmask)
        # warmup ramp: min(lam, lam * num_batch / warmup), model.py:329
        ramp = min(cfg.lam, cfg.lam * float(num_batch) / cfg.warmup)
        unsup = consis_loss(logps[:, nt:], cfg.tem, cfg.conf, cfg.loss_kind,
                            row_mask=um)
        loss = sup + ramp * unsup
        # train accuracy on the last augmentation (reference model.py:331)
        preds = logps[-1, :nt].argmax(-1)
        acc = ((preds == labels) * lmask).sum() / lmask.sum().clamp(min=1.0)

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        # the reference measures the grad norm even with clipping off
        gnorm = _global_norm(grads)
        if cfg.clip_norm > 0:
            _clip_(grads, gnorm, cfg.clip_norm)
        optimizer.step()
        return {"loss": loss.detach(), "sup_loss": sup.detach(),
                "consis_loss": unsup.detach(), "train_acc": acc,
                "grad_norm": gnorm}

    return step


def build_eval_step(cfg: StepConfig, model: MLP) -> Callable:
    """Returns evaluate(features, tk_cols, tk_vals, rows, labels, mask) ->
    (nll, acc). Reference ``valid`` (``model.py:143-166``): no DropNode,
    no dropout, BN on its running stats."""

    @torch.no_grad()
    def evaluate(features, tk_cols, tk_vals, rows, labels, mask):
        model.eval()
        x = gather_and_prop(features, tk_cols[rows], tk_vals[rows])[0]
        return _eval_metrics(torch.log_softmax(model(x), dim=-1), labels,
                             mask)

    return evaluate
