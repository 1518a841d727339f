"""Parameters across the two packages.

``grandtpu`` keeps the MLP as pytrees (numpy leaves here):

    params {'fcs': [{'w': [in, out], 'b': [out]}], 'bns': [{'scale', 'bias'}]}
    state  {'bns': [{'mean', 'var'}]}

and the MAG model adds ``params['emb'] = {'table': [V, out]}``.
:func:`mlp_from_jax` / :func:`mag_from_jax` build the port's ``MLP`` /
``MagMLP`` from them (``nn.Linear`` stores ``w`` as [out, in], so it is
transposed) and :func:`mlp_to_jax` / :func:`mag_to_jax` go back, so tests
can start both packages from the same weights and compare what they end
with. With a mesh, :func:`mag_from_jax` splits the table over its shards
(``MagMLP.shard_vocab``, or its columns over 'model' with
``emb_mode="tp"``) and :func:`mlp_from_jax` with ``tensor_parallel``
splits the hidden width (``MLP.shard_hidden``); :func:`mlp_to_jax` and
:func:`mag_to_jax` join them back into grandtpu's whole trees (a
vocab-sharded table padded as grandtpu's is). On a mesh over processes
the join is a collective: every rank calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from grandtpu_torch.nn.mag_mlp import MagMLP
from grandtpu_torch.nn.mlp import MLP, MLPConfig, fc_tensors


@torch.no_grad()
def _load_head(model: MLP | MagMLP, params, state) -> None:
    for fc, p in zip(model.fcs, params["fcs"], strict=True):
        fc.weight.copy_(torch.tensor(np.asarray(p["w"]).T))
        fc.bias.copy_(torch.tensor(np.asarray(p["b"])))
    for bn, p, s in zip(model.bns, params["bns"], state["bns"], strict=True):
        bn.weight.copy_(torch.tensor(np.asarray(p["scale"])))
        bn.bias.copy_(torch.tensor(np.asarray(p["bias"])))
        bn.running_mean.copy_(torch.tensor(np.asarray(s["mean"])))
        bn.running_var.copy_(torch.tensor(np.asarray(s["var"])))


def mlp_from_jax(params, state, mlp_cfg: MLPConfig, device, mesh=None,
                 tensor_parallel: bool = False) -> MLP:
    """``MLP`` from ``grandtpu``'s ``init_mlp`` pytrees; with ``mesh`` on
    its first device, and with ``tensor_parallel`` its hidden width split
    over the mesh's 'model' axis."""
    model = MLP(mlp_cfg)
    _load_head(model, params, state)
    if mesh is None:
        return model.to(device)
    model.to(mesh.devices[0])
    return model.shard_hidden(mesh) if tensor_parallel else model


def mlp_to_jax(model: MLP | MagMLP):
    """(params, state) pytrees of numpy arrays in ``grandtpu``'s layout,
    whole."""
    def np_(t):
        return t.detach().cpu().numpy()

    mesh = model.model_mesh
    fcs = [[np_(t) for t in fc_tensors(fc, mesh)] for fc in model.fcs]
    params = {"fcs": [{"w": w.T, "b": b} for w, b in fcs],
              "bns": [{"scale": np_(bn.weight), "bias": np_(bn.bias)}
                      for bn in model.bns]}
    state = {"bns": [{"mean": np_(bn.running_mean),
                      "var": np_(bn.running_var)} for bn in model.bns]}
    return params, state


def mag_from_jax(params, state, mlp_cfg: MLPConfig, device,
                 mesh=None, emb_mode: str = "vocab") -> MagMLP:
    """``MagMLP`` from ``grandtpu``'s ``init_mag_mlp`` pytrees: the table
    [V, out] (its first V rows, if a mesh placement padded it), the fcs and
    BatchNorms as in :func:`mlp_from_jax`. With ``mesh``, the model is on
    its first device and its table placed as ``emb_mode`` says
    ("vocab": vocab-sharded, "tp": its columns split over 'model',
    "replicate": whole)."""
    model = MagMLP(mlp_cfg)
    table = np.asarray(params["emb"]["table"])[: mlp_cfg.num_features]
    with torch.no_grad():
        model.table.copy_(torch.tensor(table))
    _load_head(model, params, state)
    if mesh is None:
        return model.to(device)
    model.to(mesh.devices[0])
    if emb_mode == "vocab":
        return model.shard_vocab(mesh)
    if emb_mode == "tp":
        return model.shard_columns(mesh)
    if emb_mode != "replicate":
        raise ValueError(f"unknown emb_mode {emb_mode!r}")
    return model


def mag_to_jax(model: MagMLP):
    """(params, state) pytrees of numpy arrays in ``init_mag_mlp``'s
    layout; a vocab-sharded table joined, with its zero padding rows, and
    column blocks joined."""
    params, state = mlp_to_jax(model)
    params["emb"] = {"table": model.gathered_table().cpu().numpy()}
    return params, state
