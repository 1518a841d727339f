"""Experiment entry point (port of ``grandtpu/train/trainer.py``). Data with
CSR features goes to the MAG engine (``trainer_sparse.train_sparse``);
the dense-feature engine here runs

  load -> self-loops -> unlabeled pool -> GFPush top-k (``push_backend``:
  the host C++ kernel, or the dense or bucketed push on the device; with
  ``push_cache_dir`` through its on-disk cache) -> device-resident
  features and top-k table -> training loop (checkpoints, resume,
  preemption, the metrics stream: ``train/loop.py``) -> exact full-graph
  propagation with the best weights -> chunked classification (profiled
  with ``profile_dir``).

With ``num_devices > 1`` both engines train data-parallel on a mesh (D2,
``dist/data_parallel.py``) and predict through the row-partitioned
``dist_exact_propagate`` (D1), as grandtpu's trainers do. Once
``torch.distributed`` is initialized over several ranks, ``train(cfg)`` on
every rank, with ``num_devices`` the global shard count, trains on the mesh
over the processes (``dist.make_mesh``); every rank receives the whole
prediction and the same result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from grandtpu_torch import dist
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.data import GraphData, load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.device import resolve_device
from grandtpu_torch.dist.data_parallel import (check_batch_split,
                                               shard_batch,
                                               shard_train_inputs,
                                               split_rows)
from grandtpu_torch.infer import exact_propagator, test_accuracy
from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
from grandtpu_torch.observe import profile_trace
from grandtpu_torch.ppr import cached_gfpush, gfpush
from grandtpu_torch.train.loop import run_training_loop
from grandtpu_torch.train.step import (StepConfig, build_eval_step,
                                       build_train_step, make_optimizer)


def check_supported(cfg: GrandConfig) -> None:
    """Raise NotImplementedError for the one config field whose feature the
    port does not have, naming the ROADMAP item: the orbax checkpoint
    backend, which needs JAX's orbax package."""
    if cfg.ckpt_backend != "npz":
        raise NotImplementedError(
            f"ckpt_backend {cfg.ckpt_backend!r} is not ported (ROADMAP "
            f"Queue A 5: the orbax checkpoint backend)")


def train_mesh(cfg: GrandConfig, mesh, device: torch.device):
    """The mesh a trainer runs on: None for ``num_devices == 1``, else
    ``mesh`` (default ``make_mesh(num_devices, device=device)``), checked
    to have ``num_devices`` shards of ``device``'s type and a batch that
    splits over them (``ValueError`` before any step). A mesh with a
    'model' axis raises ``NotImplementedError``: grandtpu's trainers take
    no mesh and always build a (num_devices x 1) one
    (``grandtpu/train/trainer.py:129``)."""
    if mesh is not None and mesh.n_model > 1:
        raise NotImplementedError(
            f"train() on a mesh of {mesh.n_model} model shards: grandtpu's "
            f"trainers build a (num_devices x 1) mesh, "
            f"grandtpu/train/trainer.py:129")
    if cfg.num_devices <= 1:
        if mesh is not None and mesh.size != 1:
            raise ValueError(f"a mesh of {mesh.size} shards with "
                             f"num_devices={cfg.num_devices}")
        return None
    if mesh is None:
        mesh = dist.make_mesh(cfg.num_devices, device=device)
    if mesh.size != cfg.num_devices or mesh.devices[0].type != device.type:
        raise ValueError(f"num_devices={cfg.num_devices} on {device.type} "
                         f"but the mesh has {mesh.size} shards on "
                         f"{mesh.devices[0].type}")
    check_batch_split(mesh, cfg.batch_size, cfg.unlabel_batch_size)
    return mesh


@dataclasses.dataclass
class TrainResult:
    test_acc: float
    best_val_acc: float
    best_val_loss: float
    num_batches: int
    total_time: float
    batch_time_avg: float
    batch_time_median: float   # host seconds per step, no device sync
    preprocess_time: float
    propagate_time: float      # exact propagation, synchronized
    # the form the predict's hops ran (Propagator.last_precision: 'f32',
    # 'bf16', 'int8mxu', 'int8cast'; None on the dense backend and on a
    # mesh)
    predict_precision: Optional[str] = None
    model: Optional[nn.Module] = None   # MLP or MagMLP, best weights
    history: list = dataclasses.field(default_factory=list)
    preempted: bool = False    # a SIGTERM/SIGINT stopped the training
    # seconds a step of the groups that ended at an eval, timed to a device
    # sync (batch_time_median is the host's, which a graph replay returns
    # before the card is done)
    batch_time_synced: float = 0.0
    # scan_steps: {group length: StepGroup.stats()} of the rolled lengths
    scan_groups: dict = dataclasses.field(default_factory=dict)


def loop_result(out: dict) -> dict:
    """The TrainResult fields of ``run_training_loop``'s output."""
    bt, synced = out["batch_times"], out["synced_times"]
    return dict(
        num_batches=out["num_batch"],
        batch_time_avg=float(np.mean(bt)) if bt else 0.0,
        batch_time_median=float(np.median(bt)) if bt else 0.0,
        batch_time_synced=(sum(t for t, _ in synced)
                           / sum(k for _, k in synced)) if synced else 0.0,
        scan_groups=out["scan_groups"], history=out["history"],
        preempted=out["preempted"])


def push(cfg: GrandConfig, adj_sl, sources, device):
    """The GFPush top-k rows of ``sources``, through ``cfg.push_cache_dir``'s
    cache when it is set (grandtpu ``trainer.py:80-88``)."""
    kw = dict(prop_mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha,
              rmax=cfg.rmax, k=cfg.top_k, backend=cfg.push_backend,
              device=device)
    if cfg.push_cache_dir:
        return cached_gfpush(cfg.push_cache_dir, adj_sl, sources, **kw)
    return gfpush(adj_sl, sources, **kw)


def train(cfg: GrandConfig, data: Optional[GraphData] = None, log=None,
          device="cuda", *, mesh=None) -> TrainResult:
    """Run one GRAND+ training + exact-propagation test on ``device``.
    With ``cfg.num_devices > 1``, data-parallel on ``mesh`` (default
    ``make_mesh(num_devices, device=device)``; pass
    ``make_mesh(S, devices=[card] * S)`` to put S shards on one card)."""
    device = resolve_device(device)
    check_supported(cfg)
    mesh = train_mesh(cfg, mesh, device)
    if mesh is not None:
        device = mesh.devices[0]
    # f32 parity with grandtpu: no TF32 in matmuls or cuDNN, set
    # explicitly rather than trusting the build's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    verbose = log if log is not None else (print if cfg.visible else
                                           (lambda *a, **k: None))
    rng = np.random.RandomState(cfg.seed2)
    if data is None:
        data = load_data(cfg.dataset, split_seed=cfg.seed1)
    if data.has_sparse_features:
        # dispatch on the feature format, as grandtpu does (the
        # sparse_features flag is not read)
        from grandtpu_torch.train.trainer_sparse import train_sparse
        return train_sparse(cfg, data=data, log=log, device=device,
                            mesh=mesh)

    t_start = time.time()
    adj_sl = add_self_loops_adj(data.adj)
    # unlabeled pool, reference model.py:244-248 (including the [:-1] slice
    # quirk when unlabel_num == -1)
    idx_sample = rng.permutation(data.idx_test)[: cfg.unlabel_num]
    idx_unlabel = np.concatenate([data.idx_val, idx_sample])
    sources = np.concatenate([data.idx_train, idx_unlabel])
    tk = push(cfg, adj_sl, sources, device)
    preprocess_time = time.time() - t_start
    verbose(f"preprocessing done, time: {preprocess_time:.3f}s")

    features = torch.as_tensor(np.asarray(data.features, np.float32),
                               device=device)
    tk_cols = torch.as_tensor(tk.cols, device=device)
    tk_vals = torch.as_tensor(tk.vals, device=device)
    labels_int = data.labels_int

    n_class = data.num_classes
    mlp_cfg = MLPConfig(
        num_features=data.num_features, num_classes=n_class,
        hidden=cfg.hidden, nlayers=cfg.nlayers, use_bn=cfg.use_bn,
        node_norm=cfg.node_norm, input_droprate=cfg.input_droprate,
        hidden_droprate=cfg.hidden_droprate)
    step_cfg = StepConfig(
        mlp=mlp_cfg, k_aug=cfg.sample, dropnode_rate=cfg.dropnode_rate,
        n_train=cfg.batch_size, lam=cfg.lam, warmup=cfg.warmup, tem=cfg.tem,
        conf=cfg.resolve_conf(n_class), loss_kind=cfg.loss,
        clip_norm=cfg.clip_norm)
    model = init_mlp(mlp_cfg, cfg.seed2, device)
    optimizer = make_optimizer(model, cfg.lr, cfg.weight_decay)
    train_step = build_train_step(step_cfg, model, optimizer, mesh=mesh)
    eval_step = build_eval_step(step_cfg, model, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(cfg.seed2)

    # the whole val set in one eval call (BN in eval mode, so batching has
    # no numeric effect); on a mesh each shard evaluates a block of it
    val_rows = torch.as_tensor(tk.row_positions(data.idx_val),
                               dtype=torch.long, device=device)
    val_labels = torch.as_tensor(labels_int[data.idx_val], dtype=torch.long,
                                 device=device)
    val_mask = torch.ones(len(data.idx_val), device=device)
    step_operands, batch_transform = (features, tk_cols, tk_vals), None
    if mesh is not None:
        step_operands = shard_train_inputs(
            mesh, model=model, features=features, tk_cols=tk_cols,
            tk_vals=tk_vals)
        val_rows, val_labels, val_mask = (split_rows(mesh, t) for t in
                                          (val_rows, val_labels, val_mask))
        batch_transform = lambda b: shard_batch(mesh, b)  # noqa: E731

    out = run_training_loop(
        cfg, rng,
        step_fn=lambda batch, nb: train_step(*step_operands, batch,
                                             generator, nb),
        eval_fn=lambda: eval_step(*step_operands, val_rows, val_labels,
                                  val_mask),
        snapshot=lambda: {k: v.detach().clone()
                          for k, v in model.state_dict().items()},
        train_positions=tk.row_positions(data.idx_train),
        sample_positions=tk.row_positions(idx_sample),
        train_labels_all=labels_int[data.idx_train],
        device=device, verbose=verbose, model=model, optimizer=optimizer,
        edges_per_step=(cfg.batch_size + cfg.unlabel_batch_size) * tk.k
        * cfg.sample,
        batch_transform=batch_transform, generators=(generator,))
    best = out["best"]
    model.load_state_dict(best["state"])
    step_operands = None

    # exact full-graph propagation test with the best weights; on a mesh
    # row-partitioned (D1), as grandtpu's; profiled with profile_dir
    with profile_trace(cfg.profile_dir):
        t_prop = time.time()
        if mesh is not None:
            prop = dist.dist_exact_propagate(
                mesh, adj_sl, features, mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, precision=cfg.predict_precision)
            predict_precision = None
        else:
            propagator, precision = exact_propagator(
                adj_sl, features.shape[1], precision=cfg.predict_precision,
                device=device)
            prop = propagator(features, mode=cfg.prop_mode, order=cfg.order,
                              alpha=cfg.alpha, precision=precision)
            predict_precision = propagator.last_precision
            del propagator  # the operator, before the head's activations
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        propagate_time = time.time() - t_prop
        test_acc = test_accuracy(model, prop, data.idx_test, labels_int)
    total_time = time.time() - t_start
    verbose(f"Total time elapsed: {total_time:.4f}s")
    verbose(f"Test Accuracy {test_acc:.4f}")
    return TrainResult(
        test_acc=test_acc, best_val_acc=best["acc"],
        best_val_loss=best["loss"], total_time=total_time,
        preprocess_time=preprocess_time, propagate_time=propagate_time,
        predict_precision=predict_precision, model=model,
        **loop_result(out))
