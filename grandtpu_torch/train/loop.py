"""Host-side training loop (port of ``grandtpu/train/loop.py``).

Around the step, it does what the reference's epoch x batch loop does
(``model.py:302-362``): assemble each epoch's batches on the host and
upload them once, evaluate every ``eval_batch`` steps, early-stop on
patience with the acc/both rules, and keep the best state. It makes the
same ``RandomState`` calls in the same order as ``grandtpu``, so both
packages see identical batch schedules. With ``ckpt_dir`` it writes
``{ckpt_dir}/best.npz`` at every eval that improves, as grandtpu does
(``grandtpu/train/loop.py:273-281``). On a mesh over processes every rank
runs this loop: the eval metrics are replicated, so every rank takes the
same improvement and stop decisions, gathers the checkpoint's trees, and
rank 0 alone writes the file. Resume, periodic full-state saves, metrics streams,
scan-rolled steps and preemption are not ported
(``trainer.check_supported`` rejects their config fields).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.train.checkpoint import model_trees, save_checkpoint


def pad_batch(idx: np.ndarray, size: int):
    """Pad a partial batch by wrapping its own rows; mask marks real rows."""
    mask = np.zeros(size, dtype=np.float32)
    mask[: idx.shape[0]] = 1.0
    if idx.shape[0] < size:
        reps = -(-size // idx.shape[0])
        idx = np.tile(idx, reps)[:size]
    return idx, mask


def run_training_loop(cfg: GrandConfig, rng: np.random.RandomState, *,
                      step_fn, eval_fn, snapshot, train_positions,
                      sample_positions, train_labels_all, device,
                      verbose, model=None, batch_transform=None,
                      row_padded=None):
    """Run the early-stopped training.

    step_fn(batch, num_batch) -> metrics; eval_fn() -> (val_loss, val_acc);
    snapshot() -> a copy of the model state, kept for the best eval;
    ``model``: the trained module, saved at each improving eval when
    ``cfg.ckpt_dir`` is set (a vocab-sharded table gathered, with the
    ``row_padded`` meta, as grandtpu writes a mesh run's);
    ``batch_transform``: applied to each step's batch (a mesh's
    ``shard_batch``, grandtpu ``loop.py:236-237``).
    Returns a dict with the best eval (``best``: acc, loss, state, batch,
    epoch), ``num_batch``, per-step host ``batch_times`` and ``history``.
    """
    best = {"acc": 0.0, "loss": np.inf, "state": snapshot(),
            "batch": 0, "epoch": 0}
    bad_counter = 0
    num_batch = 0
    batch_times: list[float] = []
    history: list[dict] = []
    stop = False

    for epoch in range(cfg.epochs):
        order_perm = rng.permutation(len(train_positions))
        n_steps = -(-len(order_perm) // cfg.batch_size)
        rows_np = np.empty((n_steps, cfg.batch_size
                            + cfg.unlabel_batch_size), np.int64)
        labels_np = np.empty((n_steps, cfg.batch_size), np.int64)
        masks_np = np.empty((n_steps, cfg.batch_size), np.float32)
        umasks_np = np.empty((n_steps, cfg.unlabel_batch_size), np.float32)
        for i, start in enumerate(range(0, len(order_perm),
                                        cfg.batch_size)):
            sel = order_perm[start: start + cfg.batch_size]
            tr_idx, label_mask = pad_batch(sel, cfg.batch_size)
            # unlabeled batch: uniform subsample (reference model.py:107-113)
            un_sel = rng.permutation(len(sample_positions))[
                : cfg.unlabel_batch_size]
            un_idx, un_mask = pad_batch(un_sel, cfg.unlabel_batch_size)
            rows_np[i] = np.concatenate([train_positions[tr_idx],
                                         sample_positions[un_idx]])
            labels_np[i] = train_labels_all[tr_idx]
            masks_np[i] = label_mask
            umasks_np[i] = un_mask
        rows_e, labels_e, masks_e, umasks_e = (
            torch.as_tensor(a, device=device)
            for a in (rows_np, labels_np, masks_np, umasks_np))

        for i in range(n_steps):
            bt0 = time.time()
            batch = {"rows": rows_e[i], "labels": labels_e[i],
                     "label_mask": masks_e[i], "unlabel_mask": umasks_e[i]}
            if batch_transform is not None:
                batch = batch_transform(batch)
            metrics = step_fn(batch, num_batch)
            batch_times.append(time.time() - bt0)

            if num_batch % cfg.eval_batch == 0:
                val_loss, val_acc = (float(v) for v in eval_fn())
                train_loss = float(metrics["loss"])
                history.append({"batch": num_batch, "val_loss": val_loss,
                                "val_acc": val_acc, "loss": train_loss})
                verbose(f"epoch {epoch}, batch {num_batch}, "
                        f"validation loss {val_loss:.4f}, "
                        f"validation acc {val_acc:.4f}")
                # reference improvement rule (model.py:344-346)
                if val_acc >= best["acc"]:
                    if cfg.stop_mode == "acc" or (
                            cfg.stop_mode == "both"
                            and val_loss <= best["loss"]):
                        best.update(acc=val_acc, loss=val_loss,
                                    state=snapshot(), batch=num_batch,
                                    epoch=epoch)
                        bad_counter = 0
                        if cfg.ckpt_dir:
                            params, state = model_trees(model)
                            save_checkpoint(
                                f"{cfg.ckpt_dir}/best.npz", params=params,
                                state=state, num_batch=num_batch,
                                best_val_acc=best["acc"],
                                best_val_loss=best["loss"],
                                row_padded=row_padded,
                                backend=cfg.ckpt_backend)
                else:
                    bad_counter += 1
                if bad_counter >= cfg.patience:
                    verbose(f"Early stop! Min loss: {best['loss']:.4f}, "
                            f"Max accuracy: {best['acc']:.4f}, "
                            f"num batch: {num_batch}, epoch: {epoch}")
                    stop = True
            if stop:
                # early stop exits BEFORE the increment, matching the
                # reference's counting (model.py:355-360)
                break
            num_batch += 1
        if stop:
            break
    verbose(f"Optimization finished. Best val acc {best['acc']:.4f} "
            f"at batch {best['batch']}")
    return {"best": best, "num_batch": num_batch,
            "batch_times": batch_times, "history": history}
