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

With ``num_devices > 1`` (D2) it trains on a mesh: the table and its Adam
moments are vocab-sharded and the step runs vocab-parallel (every shard
embeds all the batch's rows over its vocab window with the K3 window
kernel, the partial sums meet in a reduce-scatter, and the backward's
all-gather feeds each shard's window backward); the predict embeds every
node with the gathered table and propagates row-partitioned (D1). Its
steps also run on a (data, model) mesh: vocab-parallel within each model
column (the table's rows over 'data', replicated over 'model'), or
tensor-parallel (``shard_sparse_train_inputs(emb_mode="tp")``: each model
shard embeds its data row's rows over its column block of the table with
K3).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from grandtpu_torch import dist
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.data import GraphData, load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.device import resolve_device
from grandtpu_torch.dist.data_parallel import (shard_batch,
                                               shard_sparse_train_inputs,
                                               split_rows)
from grandtpu_torch.infer.classify import embed_all_nodes, head_logits
from grandtpu_torch.infer.propagate import exact_propagator
from grandtpu_torch.nn.losses import consis_loss
from grandtpu_torch.nn.mag_mlp import MagMLP, init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, embed_prop,
                                            embed_prop_window)
from grandtpu_torch.observe import profile_trace
from grandtpu_torch.train.checkpoint import adam_tree, row_padded_meta
from grandtpu_torch.train.loop import run_training_loop
from grandtpu_torch.train.step import (_clip_, _eval_metrics, _eval_sharded,
                                       _global_norm, _masked_nll,
                                       _sharded_batch, _sharded_losses,
                                       make_optimizer, num_batch_tensor)
from grandtpu_torch.train.trainer import (TrainResult, loop_result, push,
                                          train_mesh)


def _mag_ramp(num_batch, device, lam: float, warmup: float) -> torch.Tensor:
    """The MAG engine's consistency weight min(1, num_batch / warmup) * lam
    in f32 on ``device`` (``grandtpu/train/trainer_sparse.py:104``)."""
    return (num_batch_tensor(num_batch, device) / warmup).clamp(
        max=1.0) * lam


def build_sparse_steps(cfg: GrandConfig, model: MagMLP,
                       optimizer: torch.optim.Optimizer,
                       n_class: int, mesh=None) -> tuple[Callable, Callable]:
    """Returns (train_step, eval_step) for ``model``.

    train_step(attr_cols, attr_vals, tk_cols, tk_vals, batch, generator,
    num_batch) -> {"loss"}, updating ``model`` and ``optimizer`` in place;
    batch and ``num_batch`` as in ``train/step.py``'s ``build_train_step``
    (no host read: a CUDA graph can capture it). eval_step(attr_cols,
    attr_vals, tk_cols, tk_vals, rows, labels, mask) -> (nll, acc).

    With ``mesh``, the data-parallel steps, arguments as in
    ``build_train_step``'s: the tables per-shard lists
    (``shard_sparse_train_inputs``), batch ``shard_batch``'s list, the
    eval's rows, labels and mask ``split_rows``' lists. The model's table
    is vocab-sharded (``MagMLP.shard_vocab``), split by columns over
    'model' (``MagMLP.shard_columns``) or whole on the first device.
    """
    if mesh is not None:
        return _build_sharded_sparse_steps(cfg, model, optimizer, n_class,
                                           mesh)
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
        ramp = _mag_ramp(num_batch, bmask.device, cfg.lam, cfg.warmup)
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


def _build_sharded_sparse_steps(cfg: GrandConfig, model: MagMLP,
                                optimizer: torch.optim.Optimizer,
                                n_class: int, mesh) -> tuple:
    conf = cfg.resolve_conf(n_class)
    mcfg = model.cfg
    params = list(model.parameters())
    vocab = model.vocab_mesh is not None
    columns = model.model_mesh is not None
    q = cfg.input_droprate

    def embed(attr_cols, attr_vals, cols, vals, keep, drop, split):
        """The K augmentations' inputs [K, b_s, H] of each shard's rows
        ([K, b_s, H/m] column blocks with the table split over 'model');
        ``keep``/``drop`` in the batch's row order on the first device."""
        local = len(mesh.devices)
        if columns:
            # each model shard: K3 over its column block for its data
            # row's rows, the input dropout's columns of that block
            drops = [None] * local
            if drop is not None:
                w = drop.shape[-1] // mesh.n_model
                drops = [d[..., m * w:(m + 1) * w].contiguous() for d, m in
                         zip(split(drop, 1), mesh.model_shards)]
            tables = mesh.broadcast_columns(list(model.table_columns))
            return [embed_prop(t, ac, av, c, v, k, d, q) for t, ac, av, c, v,
                    k, d in zip(tables, attr_cols, attr_vals, cols, vals,
                                split(keep, 1), drops)]
        if not vocab:
            keeps, drops = split(keep, 1), ([None] * local if drop is None
                                            else split(drop, 1))
            return [embed_prop(t, ac, av, c, v, k, d, q) for t, ac, av, c, v,
                    k, d in zip(mesh.broadcast(model.table), attr_cols,
                                attr_vals, cols, vals, keeps, drops)]
        # vocab-parallel: each shard embeds every row of the batch over its
        # window; the partial sums meet in a reduce-scatter by rows, whose
        # backward all-gathers the gradient for the window backwards
        keeps = mesh.broadcast(split.to_mesh_order(keep, 1))
        drops = ([None] * local if drop is None
                 else mesh.broadcast(split.to_mesh_order(drop, 1)))
        cols_all, vals_all = mesh.all_gather(cols), mesh.all_gather(vals)
        tables = mesh.broadcast_rows(list(model.table_shards))
        partials = [embed_prop_window(t, *model.vocab_window(r), ac, av, c, v,
                                      k, d, q)
                    for r, t, ac, av, c, v, k, d in zip(
                        mesh.data_shards, tables, attr_cols, attr_vals,
                        cols_all, vals_all, keeps, drops)]
        return mesh.reduce_scatter_rows(partials, dim=1)

    def train_step(attr_cols, attr_vals, tk_cols, tk_vals, batches, generator,
                   num_batch):
        model.train()
        nts, ums, bmasks, split = _sharded_batch(mesh, batches,
                                                 cfg.batch_size)
        cols = [tc[b["rows"]] for tc, b in zip(tk_cols, batches)]
        vals = [tv[b["rows"]] for tv, b in zip(tk_vals, batches)]
        k_aug, dev = cfg.sample, generator.device
        shape = (k_aug, split.rows, cols[0].shape[1])
        # the one-device step's draws, at the batch's shapes, in its order
        keep = torch.rand(shape, generator=generator,
                          device=dev) < 1.0 - cfg.dropnode_rate
        drop = None
        if q > 0.0:
            width = mcfg.hidden if mcfg.nlayers > 1 else mcfg.num_classes
            drop = torch.rand((*shape, attr_cols[0].shape[1], width),
                              generator=generator, device=dev) < 1.0 - q
        xs = embed(attr_cols, attr_vals, cols, vals, keep, drop, split)
        outs = [model.forward_sharded(
            mesh, [x[k] for x in xs], batch_masks=bmasks if mcfg.use_bn
            else None, generator=generator, split=split)
            for k in range(k_aug)]
        logps = [torch.stack([torch.log_softmax(o[s], dim=-1) for o in outs])
                 for s in range(len(xs))]
        ramp = _mag_ramp(num_batch, dev, cfg.lam, cfg.warmup)
        loss = _sharded_losses(mesh, logps, batches, nts, ums, ramp, cfg.tem,
                               conf, cfg.loss)[0]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if cfg.clip_norm > 0:
            grads = [p.grad for p in params if p.grad is not None]
            _clip_(grads, _global_norm(grads, mesh,
                                       model.sharded_parameters(), vocab),
                   cfg.clip_norm)
        optimizer.step()
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(attr_cols, attr_vals, tk_cols, tk_vals, rows, labels, mask):
        model.eval()
        if columns:
            tables = mesh.broadcast_columns(list(model.table_columns))
        elif vocab:
            tables = mesh.all_gather(mesh.broadcast_rows(
                list(model.table_shards)))
        else:
            tables = mesh.broadcast(model.table)
        xs = [embed_prop(t, ac, av, tc[r], tv[r])[0] for t, ac, av, tc, tv, r
              in zip(tables, attr_cols, attr_vals, tk_cols, tk_vals, rows)]
        return _eval_sharded(mesh, model, xs, labels, mask)

    return train_step, eval_step


def _vocab_row_padded(num_embeddings: int, padded: int, width: int,
                      weight_decay: float) -> dict:
    """grandtpu's ``__row_padded__`` meta of a vocab-sharded table: the
    table and its two Adam moments, keyed as grandtpu's trees spell them."""
    def trees(rows):
        params = {"emb": {"table": np.broadcast_to(np.float32(0),
                                                   (rows, width))}}
        return {"params": params,
                "opt": adam_tree(params, weight_decay=weight_decay)}

    return row_padded_meta(trees(num_embeddings), trees(padded))


def train_sparse(cfg: GrandConfig, data: Optional[GraphData] = None,
                 log=None, device="cuda", *, mesh=None) -> TrainResult:
    """GRAND+ training and the exact-propagation test of the MAG engine on
    ``device``; ``data`` must have CSR features. With ``cfg.num_devices >
    1`` it trains on ``mesh`` (default ``make_mesh(num_devices,
    device=device)``), as ``train()`` does."""
    device = resolve_device(device)
    mesh = train_mesh(cfg, mesh, device)
    if mesh is not None:
        device = mesh.devices[0]
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
    tk = push(cfg, adj_sl, sources, device)
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
    val_rows = torch.as_tensor(tk.row_positions(data.idx_val),
                               dtype=torch.long, device=device)
    val_labels = torch.as_tensor(labels_int[data.idx_val], dtype=torch.long,
                                 device=device)
    val_mask = torch.ones(len(data.idx_val), device=device)
    row_padded, batch_transform = {}, None
    embed_cols, embed_vals = attr_cols, attr_vals
    if mesh is not None:
        attr_cols, attr_vals, tk_cols, tk_vals = shard_sparse_train_inputs(
            mesh, model=model, attr_cols=attr_cols, attr_vals=attr_vals,
            tk_cols=tk_cols, tk_vals=tk_vals, emb_mode="vocab")
        embed_cols, embed_vals = attr_cols[0], attr_vals[0]
        # the leaves the vocab padding grew, so that a restore slices them
        row_padded = _vocab_row_padded(
            padded.num_features, model.vocab_window(mesh.n_data - 1)[1],
            model.table_shards[0].shape[1], cfg.weight_decay)
        val_rows, val_labels, val_mask = (split_rows(mesh, t) for t in
                                          (val_rows, val_labels, val_mask))
        batch_transform = lambda b: shard_batch(mesh, b)  # noqa: E731
    # after the placement, so that Adam's moments follow the table's shards
    optimizer = make_optimizer(model, cfg.lr, cfg.weight_decay)
    train_step, eval_step = build_sparse_steps(cfg, model, optimizer,
                                               n_class, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(cfg.seed2)

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
        device=device, verbose=verbose, model=model, optimizer=optimizer,
        edges_per_step=(cfg.batch_size + cfg.unlabel_batch_size) * tk.k
        * cfg.sample,
        batch_transform=batch_transform, row_padded=row_padded,
        generators=(generator,))
    best = out.pop("best")
    model.load_state_dict(best.pop("state"))

    # predict, phase-wise so the [n, H] power iteration never shares the
    # device with the training operands: embeddings first, then release the
    # optimizer state, the grads and the attr and top-k tables (the step
    # and eval closures read the rebound locals), then propagate, then
    # head; profiled with profile_dir
    with profile_trace(cfg.profile_dir):
        embs = embed_all_nodes(model.gathered_table(), embed_cols,
                               embed_vals)
        attr_cols = attr_vals = tk_cols = tk_vals = None
        embed_cols = embed_vals = None
        optimizer.state.clear()
        model.zero_grad(set_to_none=True)
        t_prop = time.time()
        if mesh is not None:
            # row-partitioned power iteration (D1), as grandtpu's mesh
            # predict; the sharded propagators keep no record of their
            # hops' form
            prop = dist.dist_exact_propagate(
                mesh, adj_sl, embs, mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, precision=cfg.predict_precision)
            predict_precision = None
        else:
            propagator, precision = exact_propagator(
                adj_sl, embs.shape[1], precision=cfg.predict_precision,
                device=device)
            prop = propagator(embs, mode=cfg.prop_mode, order=cfg.order,
                              alpha=cfg.alpha, precision=precision)
            predict_precision = propagator.last_precision
            del propagator  # the operator, before the head's activations
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
    return TrainResult(
        test_acc=test_acc, best_val_acc=best["acc"],
        best_val_loss=best["loss"], total_time=total_time,
        preprocess_time=preprocess_time, propagate_time=propagate_time,
        predict_precision=predict_precision, model=model,
        **loop_result(out))
