"""Sparse-feature (MAG) training engine (port of
``grandtpu/train/trainer_sparse.py``; reference ``model_mag.py:248-413``).

What differs from the dense engine, and is kept:

- the input layer is the embedding weighted mean over padded attr rows,
  run inside the K-augmentation loop with fresh input dropout; it and the
  DropNode mean are one K3 call for all K (``nn/sparse_input.py``);
- the augmentation is NOT detached: gradients flow through the DropNode
  mean and the embedding mean into the table (K3's scatter-add backward);
- the warmup ramp is ``min(1, nb / warmup) * lam``;
- Adam stays dense over the whole [V, H] table, as in ``grandtpu``
  (untouched rows still decay their moments and still move);
- prediction propagates in EMBEDDING space: all-node embeddings [n, H],
  then the power iteration (K2 at H), then the head. It never forms dense
  [n, vocab] features.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.data import GraphData, load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.device import resolve_device
from grandtpu_torch.infer.classify import embed_all_nodes, head_logits
from grandtpu_torch.infer.propagate import exact_propagator
from grandtpu_torch.nn.losses import consis_loss
from grandtpu_torch.nn.mag_mlp import MagMLP, init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.nn.sparse_input import PaddedFeatures, embed_prop
from grandtpu_torch.ppr import gfpush
from grandtpu_torch.train.loop import run_training_loop
from grandtpu_torch.train.step import (_clip_, _eval_metrics, _global_norm,
                                       _masked_nll, make_optimizer)
from grandtpu_torch.train.trainer import TrainResult, check_supported


def build_sparse_steps(cfg: GrandConfig, model: MagMLP,
                       optimizer: torch.optim.Optimizer,
                       n_class: int) -> tuple[Callable, Callable]:
    """Returns (train_step, eval_step) for ``model``.

    train_step(attr_cols, attr_vals, tk_cols, tk_vals, batch, generator,
    num_batch) -> {"loss"}, updating ``model`` and ``optimizer`` in place;
    batch as in ``train/step.py``. eval_step(attr_cols, attr_vals,
    tk_cols, tk_vals, rows, labels, mask) -> (nll, acc).
    """
    conf = cfg.resolve_conf(n_class)
    mcfg = model.cfg
    params = list(model.parameters())

    def forward_k(attr_cols, attr_vals, tk_cols, tk_vals, rows, generator,
                  batch_mask):
        cols, vals = tk_cols[rows], tk_vals[rows]           # [B, Ktop]
        k_aug, dev = cfg.sample, cols.device
        # K augmentations, each with fresh DropNode and input-dropout masks
        keep = torch.rand((k_aug, *cols.shape), generator=generator,
                          device=dev) < 1.0 - cfg.dropnode_rate
        drop = None
        if cfg.input_droprate > 0.0:
            drop = torch.rand(
                (k_aug, *cols.shape, attr_cols.shape[1],
                 model.table.shape[1]), generator=generator,
                device=dev) < 1.0 - cfg.input_droprate
        x = embed_prop(model.table, attr_cols, attr_vals, cols, vals, keep,
                       drop, cfg.input_droprate)            # [K, B, H]
        # K sequential heads: the BN running stats update in order
        return torch.stack([
            torch.log_softmax(model(x[k], batch_mask=batch_mask,
                                    generator=generator), dim=-1)
            for k in range(k_aug)])

    def train_step(attr_cols, attr_vals, tk_cols, tk_vals, batch, generator,
                   num_batch):
        model.train()
        nt = cfg.batch_size
        um = batch.get("unlabel_mask")
        if um is None:
            um = torch.ones(batch["rows"].shape[0] - nt,
                            device=batch["rows"].device)
        bmask = torch.cat([batch["label_mask"], um])
        logps = forward_k(attr_cols, attr_vals, tk_cols, tk_vals,
                          batch["rows"], generator,
                          bmask if mcfg.use_bn else None)
        sup = _masked_nll(logps[:, :nt], batch["labels"], batch["label_mask"])
        ramp = min(1.0, float(num_batch) / cfg.warmup) * cfg.lam
        unsup = consis_loss(logps[:, nt:], cfg.tem, conf, cfg.loss,
                            row_mask=um)
        loss = sup + ramp * unsup

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if cfg.clip_norm > 0:
            grads = [p.grad for p in params if p.grad is not None]
            _clip_(grads, _global_norm(grads), cfg.clip_norm)
        optimizer.step()
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(attr_cols, attr_vals, tk_cols, tk_vals, rows, labels, mask):
        model.eval()
        x = embed_prop(model.table, attr_cols, attr_vals, tk_cols[rows],
                       tk_vals[rows])[0]
        return _eval_metrics(torch.log_softmax(model(x), dim=-1), labels,
                             mask)

    return train_step, eval_step


def train_sparse(cfg: GrandConfig, data: Optional[GraphData] = None,
                 log=None, device="cuda") -> TrainResult:
    """GRAND+ training and the exact-propagation test of the MAG engine on
    ``device``; ``data`` must have CSR features."""
    device = resolve_device(device)
    check_supported(cfg)
    verbose = log if log is not None else (print if cfg.visible else
                                           (lambda *a, **k: None))
    rng = np.random.RandomState(cfg.seed2)
    if data is None:
        data = load_data(cfg.dataset, split_seed=cfg.seed1)
    if not data.has_sparse_features:
        raise ValueError("train_sparse needs CSR features; use train()")

    t_start = time.time()
    adj_sl = add_self_loops_adj(data.adj)
    idx_sample = rng.permutation(data.idx_test)[: cfg.unlabel_num]
    idx_unlabel = np.concatenate([data.idx_val, idx_sample])
    sources = np.concatenate([data.idx_train, idx_unlabel])
    tk = gfpush(adj_sl, sources, prop_mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, rmax=cfg.rmax, k=cfg.top_k,
                backend=cfg.push_backend, device=device)
    padded = PaddedFeatures.from_csr(data.features)
    preprocess_time = time.time() - t_start
    verbose(f"preprocessing done, time: {preprocess_time:.3f}s")

    attr_cols = torch.as_tensor(padded.attr_cols, device=device)
    attr_vals = torch.as_tensor(padded.attr_vals, device=device)
    tk_cols = torch.as_tensor(tk.cols, device=device)
    tk_vals = torch.as_tensor(tk.vals, device=device)
    labels_int = data.labels_int
    n_class = data.num_classes

    mlp_cfg = MLPConfig(
        num_features=padded.num_features, num_classes=n_class,
        hidden=cfg.hidden, nlayers=cfg.nlayers, use_bn=cfg.use_bn,
        node_norm=cfg.node_norm, input_droprate=cfg.input_droprate,
        hidden_droprate=cfg.hidden_droprate)
    model = init_mag_mlp(mlp_cfg, cfg.seed2, device)
    optimizer = make_optimizer(model, cfg.lr, cfg.weight_decay)
    train_step, eval_step = build_sparse_steps(cfg, model, optimizer,
                                               n_class)
    generator = torch.Generator(device=device).manual_seed(cfg.seed2)

    val_rows = torch.as_tensor(tk.row_positions(data.idx_val),
                               dtype=torch.long, device=device)
    val_labels = torch.as_tensor(labels_int[data.idx_val], dtype=torch.long,
                                 device=device)
    val_mask = torch.ones(len(data.idx_val), device=device)

    out = run_training_loop(
        cfg, rng,
        step_fn=lambda batch, nb: train_step(attr_cols, attr_vals, tk_cols,
                                             tk_vals, batch, generator, nb),
        eval_fn=lambda: eval_step(attr_cols, attr_vals, tk_cols, tk_vals,
                                  val_rows, val_labels, val_mask),
        snapshot=lambda: {k: v.detach().clone()
                          for k, v in model.state_dict().items()},
        train_positions=tk.row_positions(data.idx_train),
        sample_positions=tk.row_positions(idx_sample),
        train_labels_all=labels_int[data.idx_train],
        device=device, verbose=verbose, model=model)
    best = out.pop("best")
    model.load_state_dict(best.pop("state"))

    # predict, phase-wise so the [n, H] power iteration never shares the
    # device with the training operands: embeddings first, then release the
    # optimizer state, the grads and the attr and top-k tables (the step
    # and eval closures read the rebound locals), then propagate, then head
    embs = embed_all_nodes(model.table.detach(), attr_cols, attr_vals)
    attr_cols = attr_vals = tk_cols = tk_vals = None
    optimizer.state.clear()
    model.zero_grad(set_to_none=True)
    t_prop = time.time()
    propagator, precision = exact_propagator(
        adj_sl, embs.shape[1], precision=cfg.predict_precision,
        device=device)
    prop = propagator(embs, mode=cfg.prop_mode, order=cfg.order,
                      alpha=cfg.alpha, precision=precision)
    predict_precision = propagator.last_precision
    del propagator      # the operator, before the head's activations
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    propagate_time = time.time() - t_prop
    del embs
    logits = head_logits(model, prop)
    del prop
    preds = logits.argmax(1)
    test_acc = float(np.equal(preds[data.idx_test],
                              labels_int[data.idx_test]).mean())
    total_time = time.time() - t_start
    verbose(f"Test Accuracy {test_acc:.4f}")
    bt = out["batch_times"]
    return TrainResult(
        test_acc=test_acc, best_val_acc=best["acc"],
        best_val_loss=best["loss"], num_batches=out["num_batch"],
        total_time=total_time,
        batch_time_avg=float(np.mean(bt)) if bt else 0.0,
        batch_time_median=float(np.median(bt)) if bt else 0.0,
        preprocess_time=preprocess_time, propagate_time=propagate_time,
        predict_precision=predict_precision, model=model,
        history=out["history"])
