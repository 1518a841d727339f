"""Data-parallel placement of the training step (port of
``grandtpu/dist/data_parallel.py``, D2).

grandtpu places its one jitted step on a mesh with GSPMD shardings, and
XLA inserts the collectives. The port has no compiler to insert them: its
mesh steps (``build_train_step``/``build_eval_step`` of
``train/step.py``, ``build_sparse_steps`` of ``train/trainer_sparse.py``,
each with ``mesh=``) call the :class:`~grandtpu_torch.dist.mesh.Mesh`'s
differentiable collectives themselves, so that the S-shard step equals
the one-device step, on one process or across ``torch.distributed``
ranks. The placement, on the mesh's 'data' axis (on a 2-D mesh every
model shard of a data row holds what this says of the row):

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
  (``emb_mode="vocab"``: row-padded with zero rows to a multiple of the
  n data rows, data row d owns rows [d V/n, (d+1) V/n) on the device of
  its first shard, rank r the rows of its own data rows; on a 2-D mesh
  every model shard of the row reads them, as grandtpu's
  ``P('data', None)``) or replicated.

Tensor parallelism, on the 'model' axis (grandtpu's ``_shard_params_tp``
and ``emb_mode="tp"``): ``tensor_parallel=True`` makes the dense MLP's
first fc column-parallel (its weight and bias split over the hidden
width) and every later fc row-parallel (its weight split over its input
width, its bias replicated and added once, after the model sum); with one
layer everything stays replicated. ``emb_mode="tp"`` splits the MAG
table's columns over 'model' ([V, H/m] a model shard, replicated over
'data') and makes the head's first fc row-parallel; the rest of the head
stays replicated. Each model shard's block is an ``nn.Parameter`` of its
own on the device of the first of its column's local shards; a width that
does not divide over 'model' raises, as grandtpu's ``device_put`` does.
"""

from __future__ import annotations

import functools

import torch

from grandtpu_torch.dist.mesh import Mesh
from grandtpu_torch.nn.mlp import split_parameters


def check_batch_split(mesh: Mesh, batch_size: int,
                      unlabel_batch_size: int) -> None:
    """Raise ``ValueError`` unless both parts of a batch split evenly over
    the mesh's data axis (grandtpu's ``device_put`` raises on such a
    batch too)."""
    s = mesh.n_data
    if batch_size % s or unlabel_batch_size % s:
        raise ValueError(
            f"batch_size {batch_size} and unlabel_batch_size "
            f"{unlabel_batch_size} must both divide over the mesh's {s} "
            f"shards")


@functools.lru_cache(maxsize=16)
def _mesh_order(mesh: Mesh, n_train: int, n_unlabeled: int) -> torch.Tensor:
    s = mesh.n_data
    a, b = n_train // s, n_unlabeled // s
    blocks = [torch.cat([torch.arange(i * a, (i + 1) * a),
                         n_train + torch.arange(i * b, (i + 1) * b)])
              for i in range(s)]
    return torch.cat(blocks).to(mesh.devices[0])


class BatchSplit:
    """How one batch of ``n_train`` labeled and ``n_unlabeled`` unlabeled
    rows (``rows`` in all) lies on the mesh (as :func:`shard_batch` places
    it). ``order`` [B] on the first device: the batch position of each row
    in data-shard order."""

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
        handed out to this process's shards: each gets its data row's
        rows."""
        return self.mesh.scatter_rows(self.to_mesh_order(t, dim), dim)


def split_rows(mesh: Mesh, x: torch.Tensor) -> list:
    """``x``'s rows in n_data nearly equal blocks, block d on the devices
    of data row d's shards, for this process's shards (rows whose results
    do not depend on each other, as an eval's)."""
    blocks = torch.tensor_split(x, mesh.n_data)
    return [blocks[s].to(d) for s, d in zip(mesh.data_shards, mesh.devices)]


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
    model stays on the first device; with ``tensor_parallel`` its hidden
    width is split over 'model' in place (``MLP.shard_hidden``; build the
    optimizer after this call)."""
    _check_on_first(mesh, model)
    if tensor_parallel:
        model.shard_hidden(mesh)
    return tuple(mesh.broadcast(t) for t in (features, tk_cols, tk_vals))


def shard_sparse_train_inputs(mesh: Mesh, *, model, attr_cols, attr_vals,
                              tk_cols, tk_vals, emb_mode: str = "vocab"):
    """Place the MAG engine's state on the mesh. ``emb_mode="vocab"``
    vocab-shards ``model``'s table in place (``MagMLP.shard_vocab``; build
    the optimizer after this call, so that its moments follow the shards);
    ``"tp"`` splits its columns over 'model' (``MagMLP.shard_columns``);
    ``"replicate"`` keeps it whole on the first device. Returns the
    replicated (attr_cols, attr_vals, tk_cols, tk_vals), each a per-shard
    list."""
    if emb_mode not in ("vocab", "tp", "replicate"):
        raise ValueError(f"unknown emb_mode {emb_mode!r}")
    _check_on_first(mesh, model)
    if emb_mode == "vocab":
        model.shard_vocab(mesh)
    elif emb_mode == "tp":
        model.shard_columns(mesh)
    return tuple(mesh.broadcast(t)
                 for t in (attr_cols, attr_vals, tk_cols, tk_vals))


def shard_batch(mesh: Mesh, batch: dict) -> list:
    """The per-step batch (``rows`` [n_train + n_unlabeled], ``labels``
    and ``label_mask`` [n_train], optional ``unlabel_mask``
    [n_unlabeled]) split over the shards: a batch dict for each of this
    process's shards, of its data row's labeled block and unlabeled block,
    on its device."""
    n_train = batch["labels"].shape[0]
    n_unlabeled = batch["rows"].shape[0] - n_train
    check_batch_split(mesh, n_train, n_unlabeled)
    s = mesh.n_data
    rows_l = batch["rows"][:n_train].split(n_train // s)
    rows_u = batch["rows"][n_train:].split(n_unlabeled // s)
    out = [{"rows": torch.cat([rows_l[i], rows_u[i]]).to(d)}
           for i, d in zip(mesh.data_shards, mesh.devices)]
    for key in ("labels", "label_mask", "unlabel_mask"):
        if key in batch:
            for part, block in zip(out, mesh.scatter_rows(batch[key])):
                part[key] = block
    return out


def joined_state(model, optimizer) -> dict:
    """{name: (value, grad, exp_avg, exp_avg_sq)} of every parameter of
    ``model`` (None for a missing gradient or moment) and {buffer:
    (value,)}, each parameter held in blocks (``split_parameters``: a
    vocab-sharded table, the blocks split over 'model') joined whole under
    its unsharded name (``table``, ``fcs.0.weight``), a vocab-sharded
    table with its zero padding rows. On a mesh over processes a
    collective: every rank calls it."""
    def four(p):
        st = optimizer.state.get(p, {})
        return (p.detach(), p.grad, st.get("exp_avg"), st.get("exp_avg_sq"))

    split = split_parameters(model)
    blocks = {id(p) for ps, *_ in split.values() for p in ps}
    out = {name: four(p) for name, p in model.named_parameters()
           if id(p) not in blocks}
    for name, (ps, join, _) in split.items():
        parts = [four(p) for p in ps]
        out[name] = tuple(None if parts[0][i] is None
                          else join([q[i] for q in parts]) for i in range(4))
    for name, buf in model.named_buffers():
        out[name] = (buf,)
    return out
