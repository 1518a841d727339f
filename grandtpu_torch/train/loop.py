"""Host-side training loop (port of ``grandtpu/train/loop.py``).

Around the step, it does what the reference's epoch x batch loop does
(``model.py:302-362``): assemble each epoch's batches on the host and
upload them once, evaluate every ``eval_batch`` steps, early-stop on
patience with the acc/both rules, and keep the best state. It makes the
same ``RandomState`` calls in the same order as ``grandtpu``, so both
packages see identical batch schedules. Beyond the reference, as
grandtpu's:

- with ``ckpt_dir``, ``best.npz`` at every eval that improves, and with
  ``save_every`` the full training state (``latest.npz``: the weights,
  the Adam state and the NEXT step's index) every ``save_every`` evals;
  with ``ckpt_backend="orbax"`` the directories ``best/`` and ``latest/``;
- ``resume``: continue from ``latest.npz`` (the weights, the Adam state,
  the step index and the best acc/loss), with the best weights from
  ``best.npz``. As in grandtpu the epoch loop restarts at 0 with the same
  ``RandomState`` calls; the early-stop counter, the epoch and the
  generators' states are not saved;
- graceful preemption: SIGTERM or SIGINT finishes the step group in
  flight (the steps up to the next eval or the epoch's end,
  :func:`plan_groups`), saves ``latest.npz`` and stops;
- ``metrics_path``: a JSONL line an eval, ``preempted`` and ``train_end``
  (with :class:`~grandtpu_torch.observe.StepTimer`'s summary).

On a mesh over processes every rank runs this loop: the eval metrics are
replicated, so every rank takes the same improvement and stop decisions,
gathers the checkpoint's trees, and rank 0 alone writes the npz files
(every rank takes part in a directory checkpoint's save,
``ckpt_backend="orbax"``). A preemption there saves only when that save
is no collective: no parameter is sharded across the ranks (grandtpu's
rule: signals reach the ranks at different steps, and the gather is a
collective), and the checkpoints are npz files; else the ``save_every``
checkpoints, which every rank reaches together, are the resume point.

``scan_steps`` is grandtpu's scan-rolled groups (``_build_multi_step``):
a group length is rolled once it has occurred ``SCAN_COMPILE_THRESHOLD``
times, at most ``MAX_SCAN_SIZES`` lengths are, and every other group runs
step by step. A rolled group is a :class:`StepGroup`: on a card one CUDA
graph replay of its k steps, on the CPU its steps one by one. The
trajectory is per-step training's. On a mesh (``batch_transform`` set)
the option is ignored, as grandtpu ignores it there. As in grandtpu, each
group is timed as a whole and each of its steps gets the group's host time
over k, with no device sync (``batch_times``); the groups that end at an
eval are also timed to a device sync taken before the eval
(``synced_times``).
"""

from __future__ import annotations

import signal
import threading
import time

import numpy as np
import torch

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.nn.dropnode import gather_and_prop
from grandtpu_torch.nn.sparse_input import (embed_prop, embed_prop_backward,
                                            embed_prop_window,
                                            embed_prop_window_backward)
from grandtpu_torch.observe import MetricsLogger, StepTimer
from grandtpu_torch.train.adam import adam_update
from grandtpu_torch.train.checkpoint import (adam_tree, load_checkpoint,
                                             model_trees, process_ranks,
                                             restore_training,
                                             save_checkpoint,
                                             training_templates,
                                             training_trees)


# grandtpu's policy (grandtpu/train/loop.py:33-34, 214-222): roll a group
# length once it has occurred this many times, and at most this many
# lengths
SCAN_COMPILE_THRESHOLD = 3
MAX_SCAN_SIZES = 2
# the counted wrappers that a training step can launch
STEP_KERNELS = (gather_and_prop, embed_prop, embed_prop_backward,
                embed_prop_window, embed_prop_window_backward, adam_update)


def plan_groups(nb0: int, n_steps: int, eval_batch: int) -> list:
    """grandtpu's ``_plan_groups``: an epoch's steps cut into groups that
    end exactly at the eval steps (num_batch % eval_batch == 0) or at the
    epoch's end. Returns [(epoch-local start, length, eval_after)]."""
    groups = []
    i = 0
    while i < n_steps:
        nb = nb0 + i
        nxt = nb if nb % eval_batch == 0 else \
            nb + (eval_batch - nb % eval_batch)
        k = min(nxt - nb + 1, n_steps - i)
        groups.append((i, k, nb + k - 1 == nxt))
        i += k
    return groups


def scan_rolls(scan_seen: dict, scan_sizes: set, k: int) -> bool:
    """grandtpu's rule, in its order: count one more group of length ``k``
    in ``scan_seen``, admit ``k`` to ``scan_sizes`` when it is longer than
    1, the threshold is reached and there is room; return whether a group
    of length ``k`` is rolled."""
    scan_seen[k] = scan_seen.get(k, 0) + 1
    if (k > 1 and k not in scan_sizes and len(scan_sizes) < MAX_SCAN_SIZES
            and scan_seen[k] >= SCAN_COMPILE_THRESHOLD):
        scan_sizes.add(k)
    return k in scan_sizes


class StepGroup:
    """k consecutive training steps run as one unit.

    ``step_fn(batch, num_batch) -> metrics`` reads its batch and its step
    index (a 0-d f32 tensor) from static buffers [k, ...], into which each
    call copies the group's slices of the epoch's tensors. On a CUDA device
    the first call captures the k steps into a ``torch.cuda.CUDAGraph``
    (``generators``, the steps' ``torch.Generator``s, registered with it, so
    that each replay draws what the same steps would draw eagerly and
    advances them as far) and every call replays it: one launch for the
    group. The capture runs nothing, so the launches that the counted
    wrappers (``STEP_KERNELS``) recorded during it are taken back and added
    again at each replay. A failed capture or replay raises. On the CPU the
    steps run one by one from the buffers.

    The graph reads the model's parameters and buffers, the optimizer's
    state (its moments and step count, from which each replayed step
    computes its bias corrections) and the step's operands by address:
    they must be updated in place, never rebound, while the group lives
    (a checkpoint restore copies into them).
    """

    def __init__(self, k: int, step_fn, epoch: dict, device,
                 generators=()):
        self.k, self.step_fn, self.device = k, step_fn, torch.device(device)
        self.generators = tuple(generators)
        self.buffers = {name: torch.empty((k, *t.shape[1:]), dtype=t.dtype,
                                          device=self.device)
                        for name, t in epoch.items()}
        self.num_batch = torch.empty(k, dtype=torch.float32,
                                     device=self.device)
        self.graph = self.loss = None
        self.launches: dict = {}    # wrapper -> its launches a replay
        self.runs = 0
        self.pool_bytes = 0         # device memory the capture reserved
        self.capture_s = 0.0        # host seconds the capture took

    def _steps(self) -> torch.Tensor:
        for i in range(self.k):
            metrics = self.step_fn({name: b[i] for name, b in
                                    self.buffers.items()}, self.num_batch[i])
        return metrics["loss"]

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = {fn: fn.launches for fn in STEP_KERNELS}
        torch.cuda.synchronize(self.device)
        t0 = time.time()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            with torch.cuda.graph(graph):
                loss = self._steps()
        finally:
            self.launches = {fn: fn.launches - n for fn, n in before.items()
                             if fn.launches != n}
            for fn, n in before.items():
                fn.launches = n
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.time() - t0
        self.graph, self.loss = graph, loss

    def __call__(self, epoch: dict, num_batch: torch.Tensor,
                 i0: int) -> torch.Tensor:
        """Run the group of the epoch's steps i0 .. i0 + k - 1 (``epoch``:
        the epoch's tensors by batch key, ``num_batch`` its [n_steps] step
        indices); returns the last step's loss, which on a card the next
        call overwrites."""
        for name, b in self.buffers.items():
            b.copy_(epoch[name][i0:i0 + self.k])
        self.num_batch.copy_(num_batch[i0:i0 + self.k])
        self.runs += 1
        if self.device.type != "cuda":
            return self._steps()
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.loss

    def stats(self) -> dict:
        """runs, whether a graph was captured, its pool's reserved bytes,
        the capture's host seconds and the launches a replay adds, by
        wrapper name."""
        return {"runs": self.runs, "graph": self.graph is not None,
                "pool_bytes": self.pool_bytes, "capture_s": self.capture_s,
                "launches": {fn.__name__: n
                             for fn, n in self.launches.items()}}


class _PreemptionGuard:
    """SIGTERM/SIGINT set a flag that the loop reads at the end of each step
    group. Handlers install only on the main thread (a limit of the signal
    module); elsewhere the guard is inert. The previous handlers come back
    on exit."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._SIGNALS:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


def pad_batch(idx: np.ndarray, size: int):
    """Pad a partial batch by wrapping its own rows; mask marks real rows."""
    mask = np.zeros(size, dtype=np.float32)
    mask[: idx.shape[0]] = 1.0
    if idx.shape[0] < size:
        reps = -(-size // idx.shape[0])
        idx = np.tile(idx, reps)[:size]
    return idx, mask


def _unsaveable(cfg: GrandConfig, model) -> str | None:
    """Why a preemption must not save on this rank, or None: grandtpu's
    ``saveable`` rule (``loop.py:307-329``). A signal reaches each rank at
    its own step, so a save that is a collective over the ranks could
    meet another rank's step collective and wait for ever: the gather of
    a parameter split across processes, and the directory checkpoint's
    save over several ranks."""
    if any(m is not None and m.multiprocess
           for m in (getattr(model, "vocab_mesh", None),
                     getattr(model, "model_mesh", None))):
        return "cross-process-sharded state"
    if cfg.ckpt_backend == "orbax" and process_ranks()[1] > 1:
        return "the directory checkpoint's save is a collective"
    return None


def _resume(cfg: GrandConfig, model, optimizer, best: dict, snapshot,
            verbose) -> int:
    """Load ``latest.npz`` into ``model`` and ``optimizer``, the best
    acc/loss into ``best`` and the best weights from ``best.npz`` (the
    loaded ones when it is missing). Returns the step index to continue
    at (0 when there is no checkpoint)."""
    latest = f"{cfg.ckpt_dir}/latest.npz"
    params_t, state_t = training_templates(model)
    opt_t = (None if optimizer is None
             else adam_tree(params_t, weight_decay=cfg.weight_decay))
    try:
        params, state, opt, meta = load_checkpoint(
            latest, params_template=params_t, state_template=state_t,
            opt_template=opt_t)
    except FileNotFoundError:
        verbose(f"no checkpoint at {latest}; starting fresh")
        return 0
    # the best weights live in best.npz, not in latest.npz: a resumed run
    # that never improves still tests with them
    try:
        bp, bs, _, _ = load_checkpoint(f"{cfg.ckpt_dir}/best.npz",
                                       params_template=params_t,
                                       state_template=state_t)
        restore_training(model, None, bp, bs)
        best["state"] = snapshot()
    except FileNotFoundError:
        bp = None
    restore_training(model, optimizer, params, state, opt)
    if bp is None:
        best["state"] = snapshot()
    best["acc"] = float(meta["best_val_acc"])
    best["loss"] = float(meta["best_val_loss"])
    num_batch = int(meta["num_batch"])
    verbose(f"resumed from {latest} at batch {num_batch}")
    return num_batch


def run_training_loop(cfg: GrandConfig, rng: np.random.RandomState, *,
                      step_fn, eval_fn, snapshot, train_positions,
                      sample_positions, train_labels_all, device,
                      verbose, model=None, optimizer=None,
                      edges_per_step: int = 0, batch_transform=None,
                      row_padded=None, generators=()):
    """Run the early-stopped training.

    step_fn(batch, num_batch) -> metrics, ``num_batch`` the step's index as
    a 0-d f32 tensor on ``device`` (with ``cfg.scan_steps`` and no
    ``batch_transform`` the rolled groups run it as :class:`StepGroup`s,
    with ``generators`` the generators it draws from);
    eval_fn() -> (val_loss, val_acc);
    snapshot() -> a copy of the model state, kept for the best eval;
    ``model`` and ``optimizer`` (its ``train.adam.Adam``): what the
    checkpoints save and a resume loads (needed with ``cfg.ckpt_dir``; a
    vocab-sharded table gathered, with the ``row_padded`` meta, as
    grandtpu writes a mesh run's); ``edges_per_step``: the StepTimer's
    edges a step; ``batch_transform``: applied to each step's batch (a
    mesh's ``shard_batch``, grandtpu ``loop.py:236-237``).
    Returns a dict with the best eval (``best``: acc, loss, state, batch,
    epoch), ``num_batch``, ``preempted``, per-step host ``batch_times``,
    ``synced_times`` ((seconds, steps) of each group that ended at an eval,
    to a device sync), ``scan_groups`` ({length: :meth:`StepGroup.stats`})
    and ``history``.
    """
    best = {"acc": 0.0, "loss": np.inf, "state": snapshot(),
            "batch": 0, "epoch": 0}
    bad_counter = 0
    num_batch = 0
    batch_times: list[float] = []
    synced_times: list[tuple] = []
    history: list[dict] = []
    stop = preempted = False
    device = torch.device(device)
    rolled = cfg.scan_steps and batch_transform is None
    if cfg.scan_steps and not rolled:
        verbose("scan_steps is ignored on a mesh: every group runs step by "
                "step, as in grandtpu (grandtpu/train/loop.py:170)")
    scan_seen: dict[int, int] = {}
    scan_sizes: set[int] = set()
    groups: dict[int, StepGroup] = {}

    metrics_log = MetricsLogger(cfg.metrics_path)
    timer = StepTimer(edges_per_step=edges_per_step)
    if cfg.resume and cfg.ckpt_dir:
        num_batch = _resume(cfg, model, optimizer, best, snapshot, verbose)

    def save(name: str, nb: int, full: bool) -> None:
        if full:
            params, state, opt = training_trees(model, optimizer,
                                                cfg.weight_decay)
        else:
            (params, state), opt = model_trees(model), None
        save_checkpoint(f"{cfg.ckpt_dir}/{name}", params=params, state=state,
                        opt_state=opt, num_batch=nb,
                        best_val_acc=best["acc"], best_val_loss=best["loss"],
                        row_padded=row_padded, backend=cfg.ckpt_backend)

    guard = _PreemptionGuard()
    with guard:
        for epoch in range(cfg.epochs):
            order_perm = rng.permutation(len(train_positions))
            n_steps = -(-len(order_perm) // cfg.batch_size)
            rows_np = np.empty((n_steps, cfg.batch_size
                                + cfg.unlabel_batch_size), np.int64)
            labels_np = np.empty((n_steps, cfg.batch_size), np.int64)
            masks_np = np.empty((n_steps, cfg.batch_size), np.float32)
            umasks_np = np.empty((n_steps, cfg.unlabel_batch_size),
                                 np.float32)
            for i, start in enumerate(range(0, len(order_perm),
                                            cfg.batch_size)):
                sel = order_perm[start: start + cfg.batch_size]
                tr_idx, label_mask = pad_batch(sel, cfg.batch_size)
                # unlabeled batch: uniform subsample (reference
                # model.py:107-113)
                un_sel = rng.permutation(len(sample_positions))[
                    : cfg.unlabel_batch_size]
                un_idx, un_mask = pad_batch(un_sel, cfg.unlabel_batch_size)
                rows_np[i] = np.concatenate([train_positions[tr_idx],
                                             sample_positions[un_idx]])
                labels_np[i] = train_labels_all[tr_idx]
                masks_np[i] = label_mask
                umasks_np[i] = un_mask
            epoch_e = {name: torch.as_tensor(a, device=device) for name, a
                       in (("rows", rows_np), ("labels", labels_np),
                           ("label_mask", masks_np),
                           ("unlabel_mask", umasks_np))}
            nb_e = torch.arange(num_batch, num_batch + n_steps,
                                dtype=torch.float32, device=device)

            for i0, k, eval_after in plan_groups(num_batch, n_steps,
                                                 cfg.eval_batch):
                bt0 = time.time()
                if scan_rolls(scan_seen, scan_sizes, k) and rolled:
                    if k not in groups:
                        groups[k] = StepGroup(k, step_fn, epoch_e, device,
                                              generators)
                    last_loss = groups[k](epoch_e, nb_e, i0)
                else:
                    for i in range(i0, i0 + k):
                        batch = {name: t[i] for name, t in epoch_e.items()}
                        if batch_transform is not None:
                            batch = batch_transform(batch)
                        last_loss = step_fn(batch, nb_e[i])["loss"]
                dt = (time.time() - bt0) / k
                batch_times.extend([dt] * k)
                timer.times.extend([dt] * k)
                num_batch += k - 1    # the global index of the group's last

                if eval_after and num_batch % cfg.eval_batch == 0:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    synced_times.append((time.time() - bt0, k))
                    val_loss, val_acc = (float(v) for v in eval_fn())
                    train_loss = float(last_loss)
                    history.append({"batch": num_batch, "val_loss": val_loss,
                                    "val_acc": val_acc, "loss": train_loss})
                    metrics_log.log(batch=num_batch, epoch=epoch,
                                    val_loss=val_loss, val_acc=val_acc,
                                    train_loss=train_loss,
                                    batch_time_s=batch_times[-1])
                    verbose(f"epoch {epoch}, batch {num_batch}, "
                            f"validation loss {val_loss:.4f}, "
                            f"validation acc {val_acc:.4f}")
                    improved = False
                    # reference improvement rule (model.py:344-346)
                    if val_acc >= best["acc"]:
                        if cfg.stop_mode == "acc" or (
                                cfg.stop_mode == "both"
                                and val_loss <= best["loss"]):
                            best.update(acc=val_acc, loss=val_loss,
                                        state=snapshot(), batch=num_batch,
                                        epoch=epoch)
                            bad_counter = 0
                            improved = True
                    else:
                        bad_counter += 1
                    if cfg.ckpt_dir:
                        if improved:
                            save("best.npz", num_batch, full=False)
                        n_evals = num_batch // cfg.eval_batch
                        if cfg.save_every and n_evals % cfg.save_every == 0:
                            # latest.npz holds the NEXT step's index, so a
                            # resume never re-runs the step it saved after
                            save("latest.npz", num_batch + 1, full=True)
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
                if guard.requested:
                    why = _unsaveable(cfg, model)
                    if not cfg.ckpt_dir:
                        verbose(f"preemption signal at batch {num_batch}: "
                                f"stopping (no ckpt_dir)")
                    elif why:
                        verbose(f"preemption signal at batch {num_batch}: "
                                f"stopping WITHOUT a fresh save ({why}; the "
                                f"last save_every checkpoint is the resume "
                                f"point)")
                    else:
                        save("latest.npz", num_batch, full=True)
                        verbose(f"preemption signal at batch {num_batch}: "
                                f"state saved, stopping (resume=True "
                                f"continues)")
                    metrics_log.log(event="preempted", num_batch=num_batch)
                    preempted = stop = True
                    break
            if stop:
                break
    metrics_log.log(event="train_end", num_batch=num_batch,
                    best_val_acc=best["acc"], **timer.summary())
    metrics_log.close()
    verbose(f"Optimization finished. Best val acc {best['acc']:.4f} "
            f"at batch {best['batch']}")
    return {"best": best, "num_batch": num_batch, "preempted": preempted,
            "batch_times": batch_times, "synced_times": synced_times,
            "scan_groups": {k: g.stats() for k, g in sorted(groups.items())},
            "history": history}
