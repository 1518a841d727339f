"""Checkpoints in grandtpu's npz format (port of
``grandtpu/train/checkpoint.py``), so that each package reads the other's.

A checkpoint is one npz of flat ``"{section}|{path}"`` arrays, ``section``
one of ``params``, ``state`` and ``opt``, and ``path`` a leaf's place in
grandtpu's pytree as ``jax.tree_util.tree_flatten_with_path`` prints it:
dict keys as ``['fcs']``, list indices as ``[0]``, joined by ``/`` (for
example ``params|['fcs']/[0]/['w']``). ``__meta__`` holds the JSON bytes of
``num_batch``, ``best_val_acc``, ``best_val_loss`` and ``__row_padded__``
(leaves a mesh placement row-padded, which a restore may slice back).

The trees are grandtpu's, as numpy: :func:`grandtpu_torch.convert.mlp_to_jax`
and ``mag_to_jax`` make them from the port's modules, ``mlp_from_jax`` and
``mag_from_jax`` build modules from them (:func:`load_model`). A full
training state (``latest.npz``) adds the ``opt`` section, optax's Adam
state: the port's ``Adam`` (``train/adam.py``) keeps the same ``mu``,
``nu`` and ``count`` (:func:`training_trees`, :func:`restore_training`).

``backend="orbax"`` (the config's ``ckpt_backend``, grandtpu's name) is
the directory form of the same flat dict, one tensor a key, written and
read through ``torch.distributed.checkpoint`` (DCP): the bytes are DCP's
(``.metadata`` and a ``__{rank}_0.distcp`` file a rank that wrote), not
orbax's. Each package reads only its own directory form; the npz is the
one both read. Over several ranks every rank takes part in the save (DCP
writes each key once, spread over the ranks), as every process takes part
in grandtpu's orbax save. A load takes a directory at the path (a
``.npz`` suffix stripped) as this form, and reads the whole dict on each
rank without a collective.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import shutil
import warnings

import numpy as np
import torch
import torch.distributed as tdist

# files that only grandtpu's orbax backend writes into its directory
_ORBAX_FILES = ("manifest.ocdbt", "_CHECKPOINT_METADATA")
# what DCP warns at every call without a process group, told so or not
_NO_DIST = "torch.distributed is (disabled|unavailable)"


class CheckpointShapeError(ValueError):
    """A checkpoint leaf does not fit the restore template (names the leaf)."""


# optax's Adam state, as grandtpu's ``make_optimizer`` chains it: the
# decayed weights' empty state (with weight decay only), the moments, the
# scale's empty state
EmptyState = collections.namedtuple("EmptyState", [])
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])


def adam_tree(mu, nu=None, count=0, weight_decay: float = 0.0):
    """grandtpu's optimizer-state tree with the Adam moments ``mu`` and
    ``nu`` (``mu`` again by default: a template of their shapes), each in
    the params' layout, for ``make_optimizer(lr, weight_decay)``."""
    adam = ScaleByAdamState(np.asarray(count, np.int32), mu,
                            mu if nu is None else nu)
    decay = (EmptyState(),) if weight_decay > 0 else ()
    return decay + (adam, EmptyState())


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in grandtpu's key order and spelling (dict keys
    sorted, as JAX flattens them; a namedtuple's fields as ``.name``)."""
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                       else key))
    return out


def _unflatten(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves,
                              f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, f), leaves,
                       f"{prefix}/.{f}" if prefix else f".{f}")
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/[{i}]" if prefix else f"[{i}]")
            for i, v in enumerate(template))
    return leaves[prefix]


def row_padded_meta(before: dict, after: dict) -> dict[str, int]:
    """``{"{section}|{path}": original dim 0}`` of every leaf that a mesh
    placement row-padded (its leading dimension grew, the others did
    not), comparing section trees (``{"params": ..., "opt": ...}``)
    before and after; stored in the checkpoint's meta so that a restore
    slices those leaves and nothing else (grandtpu ``checkpoint.py:32``)."""
    out: dict[str, int] = {}
    for name, tree_b in before.items():
        flat_a = _flatten_with_paths(after[name])
        for key, leaf in _flatten_with_paths(tree_b).items():
            sb, sa = np.shape(leaf), np.shape(flat_a[key])
            if (sb != sa and len(sa) >= 2 and len(sa) == len(sb)
                    and sa[1:] == sb[1:] and sa[0] > sb[0]):
                out[f"{name}|{key}"] = int(sb[0])
    return out


def process_ranks() -> tuple[int, int]:
    """(this process's rank, the world size) of ``torch.distributed``, or
    (0, 1) when it is not initialized."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def save_checkpoint(path: str, *, params, state, opt_state=None,
                    num_batch: int = 0, best_val_acc: float = 0.0,
                    best_val_loss: float = float("inf"),
                    extra: dict | None = None,
                    row_padded: dict[str, int] | None = None,
                    backend: str = "npz") -> bool:
    """Write the ``params``/``state``/``opt_state`` trees (numpy leaves, in
    grandtpu's layout) and the meta to ``path``: an npz, or with
    ``backend="orbax"`` the directory ``path`` without its ``.npz``
    (:func:`_save_directory`). Returns whether this process wrote: with
    ``torch.distributed`` initialized over several ranks the npz is rank
    0's alone, as in grandtpu (``checkpoint.py:78-92``), and the directory
    every rank's, each rank taking part. Every rank calls it, with the
    same whole trees (a vocab-sharded table's gather before it is a
    collective)."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    rank, _ = process_ranks()
    if backend == "npz" and rank != 0:
        return False
    arrays = {}
    for name, tree in (("params", params), ("state", state),
                       ("opt", opt_state)):
        if tree is not None:
            for k, v in _flatten_with_paths(tree).items():
                arrays[f"{name}|{k}"] = v
    meta = {"num_batch": num_batch, "best_val_acc": best_val_acc,
            "best_val_loss": best_val_loss,
            "__row_padded__": row_padded or {}, **(extra or {})}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    if backend == "orbax":
        _save_directory(_orbax_dir(path), arrays)
        return True
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return True


def _save_directory(d: str, arrays: dict) -> None:
    """``dcp.save`` of ``arrays`` (one CPU tensor a key) into the sibling
    ``d.partial``, over every rank of ``torch.distributed`` when it is
    initialized (a collective: DCP's planner writes each key on one rank),
    then rank 0 moves it into place: ``d`` is replaced only once DCP's
    collective finish has written the metadata, so a save cut short leaves
    the previous ``d`` readable (for the instant between the two renames
    there is only ``d.old``). Returns on every rank once ``d`` is in
    place."""
    rank, world = process_ranks()
    partial, old = f"{d}.partial", f"{d}.old"
    if rank == 0:
        shutil.rmtree(partial, ignore_errors=True)
        os.makedirs(os.path.dirname(os.path.abspath(d)), exist_ok=True)
    if world > 1:
        tdist.barrier()             # no rank writes into a stale partial
    # imported here: its import takes about a second, which npz users skip
    import torch.distributed.checkpoint as dcp

    # a copy only of what is not a contiguous, writable array already
    tensors = {k: torch.from_numpy(np.require(v, requirements="CW"))
               for k, v in arrays.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_DIST)
        dcp.save(tensors, checkpoint_id=partial, no_dist=world == 1)
    if rank == 0:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(d):
            os.replace(d, old)
        os.replace(partial, d)
        shutil.rmtree(old, ignore_errors=True)
    if world > 1:
        tdist.barrier()


def _orbax_dir(path: str) -> str:
    """A directory checkpoint's path: a stray ``.npz`` suffix stripped."""
    return path[: -len(".npz")] if path.endswith(".npz") else path


def _load_directory(d: str) -> dict:
    """The flat dict of the directory checkpoint ``d`` as numpy arrays:
    each key's size and dtype from DCP's metadata, then ``dcp.load``
    without collectives (each rank reads the whole dict)."""
    if not os.path.isdir(d):
        raise FileNotFoundError(d)
    if any(os.path.exists(os.path.join(d, f)) for f in _ORBAX_FILES):
        raise ValueError(
            f"{d} was written by grandtpu's orbax backend, which only "
            f"grandtpu reads; the port's directory checkpoints are "
            f"torch.distributed.checkpoint's. Save it as npz (the form both "
            f"packages read) with grandtpu's ckpt_backend='npz'")
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(d).read_metadata().state_dict_metadata
    tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
               for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_DIST)
        dcp.load(tensors, checkpoint_id=d, no_dist=True)
    return {k: t.numpy() for k, t in tensors.items()}


def load_checkpoint(path: str, *, params_template, state_template,
                    opt_template=None, backend: str | None = None):
    """Restore into the shapes of the templates (trees of arrays in
    grandtpu's layout) from the npz or, with ``backend=None``, the
    directory at ``path`` (modulo ``.npz``) when there is one; a missing
    checkpoint raises ``FileNotFoundError``. Returns (params, state,
    opt_state, meta) as numpy trees. A leaf whose shape differs raises
    :class:`CheckpointShapeError`, unless the meta records it as
    row-padded from the template's leading dimension: then its first rows
    are taken, as in grandtpu."""
    if backend is None:
        backend = "orbax" if os.path.isdir(_orbax_dir(path)) else "npz"
    if backend == "orbax":
        arrays = _load_directory(_orbax_dir(path))
    elif backend == "npz":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as d:
            arrays = {k: d[k] for k in d.files}
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    row_padded = meta.get("__row_padded__") or {}

    def restore(name, template):
        if template is None:
            return None
        leaves = {}
        for k, ref in _flatten_with_paths(template).items():
            full_key = f"{name}|{k}"
            try:
                arr = arrays[full_key]
            except KeyError:
                raise CheckpointShapeError(
                    f"{full_key}: missing from checkpoint {path!r}") from None
            if arr.shape != ref.shape:
                orig = row_padded.get(full_key)
                if (orig is not None and arr.ndim >= 2
                        and arr.ndim == ref.ndim
                        and arr.shape[1:] == ref.shape[1:]
                        and ref.shape[0] == orig
                        and arr.shape[0] > ref.shape[0]):
                    arr = arr[: ref.shape[0]]
                else:
                    raise CheckpointShapeError(
                        f"{full_key}: checkpoint shape {arr.shape} does not"
                        f" match template {ref.shape}"
                        + (f" (saved row-padded from dim0={orig})"
                           if orig is not None else ""))
            leaves[k] = arr
        return _unflatten(template, leaves)

    return (restore("params", params_template),
            restore("state", state_template),
            restore("opt", opt_template), meta)


def model_trees(model) -> tuple:
    """(params, state) of an ``MLP`` or ``MagMLP`` in grandtpu's layout,
    whole (a model sharded over a mesh over processes is gathered: every
    rank calls it, and then ``save_checkpoint``)."""
    from grandtpu_torch.convert import mag_to_jax, mlp_to_jax
    from grandtpu_torch.nn.mag_mlp import MagMLP

    return (mag_to_jax if isinstance(model, MagMLP) else mlp_to_jax)(model)


def load_model(path: str, mlp_cfg, *, sparse: bool, device="cuda"):
    """The ``MLP`` (or, ``sparse``, the ``MagMLP``) of ``mlp_cfg`` with the
    weights of the checkpoint at ``path``, on ``device``; and the meta."""
    from grandtpu_torch.convert import mag_from_jax, mlp_from_jax
    from grandtpu_torch.nn.mag_mlp import MagMLP
    from grandtpu_torch.nn.mlp import MLP

    template = model_trees((MagMLP if sparse else MLP)(mlp_cfg))
    params, state, _, meta = load_checkpoint(
        path, params_template=template[0], state_template=template[1])
    build = mag_from_jax if sparse else mlp_from_jax
    return build(params, state, mlp_cfg, device), meta


def _param_leaves(model) -> list:
    """(whole parameter name, its leaf's keys in grandtpu's params tree,
    whether the leaf is the parameter transposed) of an ``MLP`` or
    ``MagMLP``."""
    from grandtpu_torch.nn.mag_mlp import MagMLP

    out = ([("table", ("emb", "table"), False)]
           if isinstance(model, MagMLP) else [])
    for i in range(len(model.fcs)):
        out += [(f"fcs.{i}.weight", ("fcs", i, "w"), True),
                (f"fcs.{i}.bias", ("fcs", i, "b"), False)]
    for i in range(len(model.bns)):
        out += [(f"bns.{i}.weight", ("bns", i, "scale"), False),
                (f"bns.{i}.bias", ("bns", i, "bias"), False)]
    return out


def _leaf(tree, keys):
    return functools.reduce(lambda t, k: t[k], keys, tree)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return np.zeros_like(tree)


def training_templates(model) -> tuple:
    """(params, state) trees of ``model``'s shapes, whole and unpadded, for
    :func:`load_checkpoint` (an unsharded model of the same config on the
    CPU: no collective, and no weights read)."""
    return model_trees(type(model)(model.cfg))


def training_trees(model, optimizer, weight_decay: float) -> tuple:
    """(params, state, opt) of ``model`` and its ``train.adam.Adam`` in
    grandtpu's layout: ``opt`` is :func:`adam_tree` of the moments (zeros
    before the first step) and the step count. Whole trees, a sharded
    model's values and moments joined (a collective over processes: every
    rank calls it)."""
    from grandtpu_torch.nn.mlp import split_parameters

    params, state = model_trees(model)
    split = split_parameters(model)
    named = dict(model.named_parameters())
    mu, nu = _zeros_like(params), _zeros_like(params)
    for name, keys, transposed in _param_leaves(model):
        blocks, join, _ = split.get(name, ([named.get(name)], None, None))
        sts = [optimizer.state.get(p, {}) for p in blocks]
        for tree, key in ((mu, "mu"), (nu, "nu")):
            if key not in sts[0]:
                continue
            m = sts[0][key] if join is None else join([st[key] for st in sts])
            m = m.detach().cpu().numpy()
            _leaf(tree, keys[:-1])[keys[-1]] = m.T if transposed else m
    return params, state, adam_tree(mu, nu, int(optimizer.count),
                                    weight_decay)


@torch.no_grad()
def restore_training(model, optimizer, params, state, opt=None) -> None:
    """Load grandtpu-layout trees into ``model`` (whole or sharded: each
    block takes its part) and, with ``opt`` (optax's Adam state, as
    :func:`training_trees` writes it), the moments and the step count into
    ``optimizer``. Everything is copied in place, on the device where it
    lives (moments that do not exist yet are made), so that a CUDA graph
    that captured the step keeps reading the restored state."""
    from grandtpu_torch.nn.mlp import split_parameters

    adam = None if opt is None else next(s for s in opt if hasattr(s, "mu"))
    split = split_parameters(model)
    named = dict(model.named_parameters())
    for name, keys, transposed in _param_leaves(model):
        def cut(tree):
            a = np.asarray(_leaf(tree, keys))
            whole = torch.as_tensor(np.ascontiguousarray(
                a.T if transposed else a))
            if name not in split:
                return [named[name]], [whole]
            ps, _, cut_whole = split[name]
            return ps, cut_whole(whole)

        targets, values = cut(params)
        for p, v in zip(targets, values):
            p.copy_(v)
        if adam is None:
            continue
        for p, mu, nu in zip(targets, cut(adam.mu)[1], cut(adam.nu)[1]):
            m, v = optimizer.moments(p)
            m.copy_(mu)
            v.copy_(nu)
    if adam is not None:
        optimizer.count.copy_(torch.as_tensor(np.asarray(adam.count),
                                              dtype=torch.int32))
    for bn, s in zip(model.bns, state["bns"]):
        bn.running_mean.copy_(torch.as_tensor(np.asarray(s["mean"])))
        bn.running_var.copy_(torch.as_tensor(np.asarray(s["var"])))
