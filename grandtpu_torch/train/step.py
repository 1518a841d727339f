"""Train and eval steps (port of ``grandtpu/train/step.py``).

One training step is the reference inner loop (``model.py:303-334``):

    keep ~ Bernoulli(1 - p) per (k, row, slot), drawn from the generator
    x = K1(features, cols, vals, keep)        [K, B, F], no gradient
    for k in 1..K:  MLP(x[k]) -> log_softmax   (BN running stats update in
                                               order: K sequential updates)
    loss = mean_k masked NLL + ramp * consis_loss
    grad norm (always measured) -> [clip] -> Adam with coupled L2
    (``train/adam.py``, one launch of ``csrc/adam.cu``)

Batches are wrap-padded to a fixed size; the masks weight the padding out
of the NLL, the BN statistics and the consistency loss, so a padded step
equals a step on the true smaller batch.

With ``mesh=``, :func:`build_train_step` and :func:`build_eval_step`
return the data-parallel step and eval (D2, ``dist/data_parallel.py``),
equal to the one-device ones: each shard
runs K1 and the MLP on its rows of the batch, every random mask is drawn
at the batch's shape in the one-device order and handed out by rows, the
BN moments and the loss normalizers are the batch's, and autograd sums
the shards' gradients onto the one copy of the parameters, where the
grad norm, the clip and Adam run. On a mesh over processes each rank
holds such a copy and runs the same update on the same summed gradients.

On a 2-D mesh the model shards of a data row share its rows: K1 runs once
a data row and device, the logits are replicated over 'model' and every
loss and metric sums over 'data' alone; with the MLP split over 'model'
(``shard_train_inputs(tensor_parallel=True)``) each model shard computes
its column block of the hidden layer, and the norm that the clip takes
counts every block once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from grandtpu_torch.dist.data_parallel import BatchSplit
from grandtpu_torch.nn.dropnode import gather_and_prop
from grandtpu_torch.nn.losses import consis_loss, consis_loss_sharded
from grandtpu_torch.nn.mlp import MLP, MLPConfig
from grandtpu_torch.train.adam import Adam


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


def make_optimizer(model: MLP, lr: float, weight_decay: float) -> Adam:
    """grandtpu's optimizer (reference ``model.py:288-289``): Adam with
    coupled weight decay added to the (clipped) gradient before the
    moments, betas (0.9, 0.999), eps 1e-8, in optax's order of operations
    (:class:`~grandtpu_torch.train.adam.Adam`)."""
    return Adam(model.parameters(), lr=lr, weight_decay=weight_decay)


def num_batch_tensor(num_batch, device) -> torch.Tensor:
    """The step index as a 0-d f32 tensor on ``device``: the loop passes
    one (grandtpu's ``nb_e``, ``grandtpu/train/loop.py:212``), so that a
    captured step reads it from its buffer; a number is copied from the
    host."""
    if isinstance(num_batch, torch.Tensor):
        return num_batch.to(device=device, dtype=torch.float32)
    return torch.tensor(float(num_batch), dtype=torch.float32, device=device)


def warmup_ramp(num_batch, device, lam: float,
                warmup: float) -> torch.Tensor:
    """The consistency weight min(lam, lam * num_batch / warmup) in f32 on
    ``device``, as ``grandtpu/train/step.py:140`` computes it (reference
    ``model.py:329``)."""
    return (lam * num_batch_tensor(num_batch, device) / warmup).clamp(
        max=lam)


def _nll_sums(logps_k, labels, mask):
    """[K] masked NLL sums of logps_k [K, B, C]."""
    picked = logps_k.gather(
        -1, labels[None, :, None].expand(logps_k.shape[0], -1, 1))[..., 0]
    return -(picked * mask[None]).sum(-1)


def _masked_nll(logps_k, labels, mask):
    """Mean over K augs of masked-mean NLL. logps_k [K, B, C]."""
    per_k = _nll_sums(logps_k, labels, mask) / mask.sum().clamp(min=1.0)
    return per_k.mean()


def _masked_nll_sharded(mesh, logps_k, labels, masks):
    """:func:`_masked_nll` of the batch the shards' lists make up."""
    sums = mesh.reduce_sum([_nll_sums(lp, lab, m)
                            for lp, lab, m in zip(logps_k, labels, masks)])
    count = mesh.reduce_sum([m.sum() for m in masks])
    return (sums / count.clamp(min=1.0)).mean()


def _accuracy_sharded(mesh, logps, labels, masks):
    """Masked accuracy of the shards' log-probs [b_s, C] on the first
    device."""
    hits = mesh.reduce_sum([((lp.argmax(-1) == lab) * m).sum()
                            for lp, lab, m in zip(logps, labels, masks)])
    return hits / mesh.reduce_sum([m.sum() for m in masks]).clamp(min=1.0)


def _global_norm(grads, mesh=None, sharded=(), rows: bool = False
                 ) -> torch.Tensor:
    """The norm of all ``grads``, on the first one's device. ``sharded`` are
    the parameters of which each rank holds only its own blocks, split over
    'model' (with ``rows``: by vocabulary rows over 'data'), whose gradients
    are among ``grads``. Where those blocks span ranks, every block's norm
    is gathered, in global order, so that each rank takes the same norm and
    counts each block and each replicated gradient once."""
    dev = grads[0].device
    norms = [torch.linalg.vector_norm(g).to(dev) for g in grads]
    gather = None
    if mesh is not None and sharded and mesh.multiprocess:
        if rows:
            gather = mesh.gather_row_blocks
        elif mesh.model_group is not None:
            gather = lambda ns: mesh.gather_columns(ns, 0)  # noqa: E731
    if gather is not None:
        ids = {id(p.grad) for p in sharded}
        local = [n.reshape(1) for g, n in zip(grads, norms) if id(g) in ids]
        norms = ([n for g, n in zip(grads, norms) if id(g) not in ids]
                 + list(gather(local)))
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_(grads, gnorm: torch.Tensor, clip_norm: float) -> None:
    """Scale ``grads`` in place by min(1, clip_norm / (gnorm + 1e-6))."""
    scale = (clip_norm / (gnorm + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(scale.to(g.device))


def _unlabel_mask(batch, n_train: int):
    um = batch.get("unlabel_mask")
    if um is None:
        um = torch.ones(batch["rows"].shape[0] - n_train,
                        device=batch["rows"].device)
    return um


def _eval_metrics(logps, labels, mask):
    """(masked mean NLL, masked accuracy) of log-probs [B, C]."""
    picked = logps.gather(-1, labels[:, None])[:, 0]
    denom = mask.sum().clamp(min=1.0)
    nll = -(picked * mask).sum() / denom
    acc = ((logps.argmax(-1) == labels) * mask).sum() / denom
    return nll, acc


def build_train_step(cfg: StepConfig, model: MLP,
                     optimizer: torch.optim.Optimizer,
                     mesh=None) -> Callable:
    """Returns step(features, tk_cols, tk_vals, batch, generator, num_batch)
    -> metrics (0-d tensors), updating ``model`` and ``optimizer`` in place.
    ``num_batch`` is the step's index, a 0-d f32 tensor on the device (or a
    number); the step reads nothing back to the host, so that a CUDA graph
    can capture it (``train/loop.py``'s ``StepGroup``).

    batch = dict(rows [B] positions into the top-k table, labels [n_train],
    label_mask [n_train] f32, optional unlabel_mask [B - n_train] f32), all
    on the features' device; B = n_train + n_unlabeled.

    With ``mesh``: the data-parallel step. features, tk_cols and tk_vals
    are per-shard lists (``shard_train_inputs``), batch is
    ``shard_batch``'s list, the model and ``generator`` are on the mesh's
    first device, and so are the metrics.
    """
    if mesh is not None:
        return _build_sharded_train_step(cfg, model, optimizer, mesh)
    params = list(model.parameters())

    def step(features, tk_cols, tk_vals, batch, generator, num_batch):
        model.train()
        cols = tk_cols[batch["rows"]]                        # [B, Ktop]
        vals = tk_vals[batch["rows"]]
        nt = cfg.n_train
        um = _unlabel_mask(batch, nt)
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
        ramp = warmup_ramp(num_batch, cols.device, cfg.lam, cfg.warmup)
        unsup = consis_loss(logps[:, nt:], cfg.tem, cfg.conf, cfg.loss_kind,
                            row_mask=um)
        loss = sup + ramp * unsup
        # train accuracy on the last augmentation (reference model.py:331)
        preds = logps[-1, :nt].argmax(-1)
        acc = ((preds == labels) * lmask).sum() / lmask.sum().clamp(min=1.0)

        gnorm = _step_update(loss, params, optimizer, cfg.clip_norm)
        return {"loss": loss.detach(), "sup_loss": sup.detach(),
                "consis_loss": unsup.detach(), "train_acc": acc,
                "grad_norm": gnorm}

    return step


def _step_update(loss, params, optimizer, clip_norm: float, mesh=None,
                 sharded=()) -> torch.Tensor:
    """Backward, the grad norm (always measured; ``mesh`` and ``sharded`` as
    :func:`_global_norm` takes them), the clip, Adam; returns the norm."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in params if p.grad is not None]
    # the reference measures the grad norm even with clipping off
    gnorm = _global_norm(grads, mesh, sharded)
    if clip_norm > 0:
        _clip_(grads, gnorm, clip_norm)
    optimizer.step()
    return gnorm


def _sharded_batch(mesh, batches, n_train: int):
    """(labeled rows a shard, unlabel masks, BN row masks, the batch's
    :class:`BatchSplit`) of ``shard_batch``'s list."""
    nts = n_train // mesh.n_data
    ums = [_unlabel_mask(b, nts) for b in batches]
    bmasks = [torch.cat([b["label_mask"], um]) for b, um in zip(batches, ums)]
    n_unlabeled = ums[0].shape[0] * mesh.n_data
    return nts, ums, bmasks, BatchSplit(mesh, n_train, n_unlabeled)


def _sharded_losses(mesh, logps, batches, nts: int, ums, ramp,
                    tem: float, conf: float, loss_kind: str):
    """(loss, sup, unsup, train accuracy) of the shards' log-probs
    [K, b_s, C], each of the batch, on the first device."""
    labels = [b["labels"] for b in batches]
    lmasks = [b["label_mask"] for b in batches]
    sup = _masked_nll_sharded(mesh, [lp[:, :nts] for lp in logps], labels,
                              lmasks)
    unsup = consis_loss_sharded(mesh, [lp[:, nts:] for lp in logps], tem,
                                conf, loss_kind, row_masks=ums)
    acc = _accuracy_sharded(mesh, [lp[-1, :nts] for lp in logps], labels,
                            lmasks)
    return sup + ramp * unsup, sup, unsup, acc


def per_data_row(mesh, fn, *lists) -> list:
    """``fn(*args)`` for each local shard, once for each data row and
    device: the model shards of a row on one device share the result
    (which they must only read)."""
    made = {}
    for key, args in zip(zip(mesh.data_shards, mesh.devices), zip(*lists)):
        if key not in made:
            made[key] = fn(*args)
    return [made[key] for key in zip(mesh.data_shards, mesh.devices)]


def _build_sharded_train_step(cfg: StepConfig, model: MLP,
                              optimizer: torch.optim.Optimizer,
                              mesh) -> Callable:
    params = list(model.parameters())

    def step(features, tk_cols, tk_vals, batches, generator, num_batch):
        model.train()
        nts, ums, bmasks, split = _sharded_batch(mesh, batches, cfg.n_train)
        cols = [tc[b["rows"]] for tc, b in zip(tk_cols, batches)]
        vals = [tv[b["rows"]] for tv, b in zip(tk_vals, batches)]
        shape = (cfg.k_aug, split.rows, cols[0].shape[1])
        keeps = split(torch.rand(shape, generator=generator,
                                 device=generator.device)
                      < 1.0 - cfg.dropnode_rate, dim=1)
        xs = per_data_row(mesh, gather_and_prop, features, cols, vals,
                          keeps)                             # [K, b_s, F]
        outs = [model.forward_sharded(
            mesh, [x[k] for x in xs],
            batch_masks=bmasks if cfg.mlp.use_bn else None,
            generator=generator, split=split) for k in range(cfg.k_aug)]
        logps = [torch.stack([torch.log_softmax(o[s], dim=-1) for o in outs])
                 for s in range(len(xs))]
        ramp = warmup_ramp(num_batch, generator.device, cfg.lam, cfg.warmup)
        loss, sup, unsup, acc = _sharded_losses(
            mesh, logps, batches, nts, ums, ramp, cfg.tem, cfg.conf,
            cfg.loss_kind)
        gnorm = _step_update(loss, params, optimizer, cfg.clip_norm, mesh,
                             model.sharded_parameters())
        return {"loss": loss.detach(), "sup_loss": sup.detach(),
                "consis_loss": unsup.detach(), "train_acc": acc,
                "grad_norm": gnorm}

    return step


def _eval_sharded(mesh, model, xs, labels, masks):
    """(nll, acc) of eval-mode ``model`` on the shards' inputs ``xs``, on
    the first device."""
    logps = [torch.log_softmax(o, dim=-1)
             for o in model.forward_sharded(mesh, xs)]
    picked = [lp.gather(-1, lab[:, None])[:, 0]
              for lp, lab in zip(logps, labels)]
    denom = mesh.reduce_sum([m.sum() for m in masks]).clamp(min=1.0)
    nll = -mesh.reduce_sum([(p * m).sum() for p, m in zip(picked, masks)])
    return nll / denom, _accuracy_sharded(mesh, logps, labels, masks)


def build_eval_step(cfg: StepConfig, model: MLP, mesh=None) -> Callable:
    """Returns evaluate(features, tk_cols, tk_vals, rows, labels, mask) ->
    (nll, acc). Reference ``valid`` (``model.py:143-166``): no DropNode,
    no dropout, BN on its running stats. With ``mesh``, every argument is
    a per-shard list (the operands replicated, the rows, labels and mask
    split by ``split_rows``): each shard evaluates its rows."""
    if mesh is not None:
        @torch.no_grad()
        def evaluate_sharded(features, tk_cols, tk_vals, rows, labels, mask):
            model.eval()
            xs = per_data_row(mesh, lambda f, tc, tv, r: gather_and_prop(
                f, tc[r], tv[r])[0], features, tk_cols, tk_vals, rows)
            return _eval_sharded(mesh, model, xs, labels, mask)

        return evaluate_sharded

    @torch.no_grad()
    def evaluate(features, tk_cols, tk_vals, rows, labels, mask):
        model.eval()
        x = gather_and_prop(features, tk_cols[rows], tk_vals[rows])[0]
        return _eval_metrics(torch.log_softmax(model(x), dim=-1), labels,
                             mask)

    return evaluate
