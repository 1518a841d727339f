"""Data-parallel placement of the training step (port of
``grandtpu/dist/data_parallel.py``, D2).

grandtpu places its one jitted step on a mesh with GSPMD shardings, and
XLA inserts the collectives. The port has no compiler to insert them: its
mesh steps (``build_train_step``/``build_eval_step`` of
``train/step.py``, ``build_sparse_steps`` of ``train/trainer_sparse.py``,
each with ``mesh=``) call the :class:`~grandtpu_torch.dist.mesh.Mesh`'s
differentiable collectives themselves, so that the S-shard step equals
the one-device step, on one process or across ``torch.distributed``
ranks. The placement, on the mesh's 'data' axis:

- batch rows: split over the shards (:func:`shard_batch`); shard s holds
  labeled block s, then unlabeled block s. Every rank draws the same
  batch and the same random masks from the same seeds and keeps its own
  shards' rows;
- features [N, F], the top-k table and the attr tables: replicated, one
  copy per distinct device (they fit one card; shards on one card share
  it);
- MLP parameters, BatchNorm state and their Adam moments: one copy on the
  first device of each process, which its shards read through
  ``Mesh.broadcast`` (its backward sums the shards' gradients, over the
  ranks too); every rank runs the same Adam step on the same gradients;
- the MAG embedding table and its Adam moments: vocab-sharded
  (``emb_mode="vocab"``: row-padded with zero rows to a multiple of S,
  shard s owns rows [s V/S, (s+1) V/S) on its device, rank r the rows of
  its own shards) or replicated.

Tensor parallelism (``tensor_parallel=True``, ``emb_mode="tp"``) is
ROADMAP Queue A 24.
"""

from __future__ import annotations

import functools

import torch

from grandtpu_torch.dist.mesh import Mesh

_TP = ("ROADMAP Queue A 24: tensor parallelism (_shard_params_tp, "
       "emb_mode='tp'), split from ROADMAP Queue A 8")


def check_batch_split(mesh: Mesh, batch_size: int,
                      unlabel_batch_size: int) -> None:
    """Raise ``ValueError`` unless both parts of a batch split evenly over
    the mesh (grandtpu's ``device_put`` raises on such a batch too)."""
    s = mesh.size
    if batch_size % s or unlabel_batch_size % s:
        raise ValueError(
            f"batch_size {batch_size} and unlabel_batch_size "
            f"{unlabel_batch_size} must both divide over the mesh's {s} "
            f"shards")


@functools.lru_cache(maxsize=16)
def _mesh_order(mesh: Mesh, n_train: int, n_unlabeled: int) -> torch.Tensor:
    s = mesh.size
    a, b = n_train // s, n_unlabeled // s
    blocks = [torch.cat([torch.arange(i * a, (i + 1) * a),
                         n_train + torch.arange(i * b, (i + 1) * b)])
              for i in range(s)]
    return torch.cat(blocks).to(mesh.devices[0])


class BatchSplit:
    """How one batch of ``n_train`` labeled and ``n_unlabeled`` unlabeled
    rows (``rows`` in all) lies on the mesh (as :func:`shard_batch` places
    it). ``order`` [B] on the first device: the batch position of each row
    in shard order."""

    def __init__(self, mesh: Mesh, n_train: int, n_unlabeled: int):
        check_batch_split(mesh, n_train, n_unlabeled)
        self.mesh = mesh
        self.rows = n_train + n_unlabeled
        self.order = _mesh_order(mesh, n_train, n_unlabeled)

    def to_mesh_order(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``t``'s batch rows (along ``dim``) in shard order."""
        return t.index_select(dim, self.order.to(t.device))

    def __call__(self, t: torch.Tensor, dim: int = 0) -> list:
        """A batch-shaped tensor (its rows along ``dim``, in batch order)
        handed out to this process's shards: shard s gets its own rows."""
        return self.mesh.scatter_rows(self.to_mesh_order(t, dim), dim)


def split_rows(mesh: Mesh, x: torch.Tensor) -> list:
    """``x``'s rows in S nearly equal blocks, block s on shard s's device,
    for this process's shards (rows whose results do not depend on each
    other, as an eval's)."""
    blocks = torch.tensor_split(x, mesh.size)
    return [blocks[s].to(d) for s, d in zip(mesh.shards, mesh.devices)]


def _check_on_first(mesh: Mesh, model) -> None:
    dev = next(model.parameters()).device
    if dev != mesh.devices[0]:
        raise ValueError(f"the model is on {dev}; a mesh step keeps it on "
                         f"the first device of the mesh's shards in this "
                         f"process, {mesh.devices[0]}")


def shard_train_inputs(mesh: Mesh, *, model, features, tk_cols, tk_vals,
                       tensor_parallel: bool = False):
    """Place the dense engine's step operands on the mesh: returns the
    replicated (features, tk_cols, tk_vals), each a per-shard list. The
    model stays on the first device."""
    if tensor_parallel:
        raise NotImplementedError(f"tensor_parallel is not ported yet "
                                  f"({_TP})")
    _check_on_first(mesh, model)
    return tuple(mesh.broadcast(t) for t in (features, tk_cols, tk_vals))


def shard_sparse_train_inputs(mesh: Mesh, *, model, attr_cols, attr_vals,
                              tk_cols, tk_vals, emb_mode: str = "vocab"):
    """Place the MAG engine's state on the mesh. ``emb_mode="vocab"``
    vocab-shards ``model``'s table in place (``MagMLP.shard_vocab``; build
    the optimizer after this call, so that its moments follow the shards);
    ``"replicate"`` keeps it whole on the first device. Returns the
    replicated (attr_cols, attr_vals, tk_cols, tk_vals), each a per-shard
    list."""
    if emb_mode == "tp":
        raise NotImplementedError(f"emb_mode 'tp' is not ported yet ({_TP})")
    if emb_mode not in ("vocab", "replicate"):
        raise ValueError(f"unknown emb_mode {emb_mode!r}")
    _check_on_first(mesh, model)
    if emb_mode == "vocab":
        model.shard_vocab(mesh)
    return tuple(mesh.broadcast(t)
                 for t in (attr_cols, attr_vals, tk_cols, tk_vals))


def shard_batch(mesh: Mesh, batch: dict) -> list:
    """The per-step batch (``rows`` [n_train + n_unlabeled], ``labels``
    and ``label_mask`` [n_train], optional ``unlabel_mask``
    [n_unlabeled]) split over the shards: a batch dict for each of this
    process's shards, of its labeled block and its unlabeled block, on its
    device."""
    n_train = batch["labels"].shape[0]
    n_unlabeled = batch["rows"].shape[0] - n_train
    check_batch_split(mesh, n_train, n_unlabeled)
    s = mesh.size
    rows_l = batch["rows"][:n_train].split(n_train // s)
    rows_u = batch["rows"][n_train:].split(n_unlabeled // s)
    out = [{"rows": torch.cat([rows_l[i], rows_u[i]]).to(d)}
           for i, d in zip(mesh.shards, mesh.devices)]
    for key in ("labels", "label_mask", "unlabel_mask"):
        if key in batch:
            for part, block in zip(out, mesh.scatter_rows(batch[key])):
                part[key] = block
    return out
