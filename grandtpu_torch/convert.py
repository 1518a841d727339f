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
(``MagMLP.shard_vocab``) and :func:`mag_to_jax` joins them back, padded
as grandtpu's vocab-sharded table is.
"""

from __future__ import annotations

import numpy as np
import torch

from grandtpu_torch.nn.mag_mlp import MagMLP
from grandtpu_torch.nn.mlp import MLP, MLPConfig


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


def mlp_from_jax(params, state, mlp_cfg: MLPConfig, device) -> MLP:
    model = MLP(mlp_cfg)
    _load_head(model, params, state)
    return model.to(device)


def mlp_to_jax(model: MLP | MagMLP):
    """(params, state) pytrees of numpy arrays in ``grandtpu``'s layout."""
    def np_(t):
        return t.detach().cpu().numpy()

    params = {"fcs": [{"w": np_(fc.weight).T, "b": np_(fc.bias)}
                      for fc in model.fcs],
              "bns": [{"scale": np_(bn.weight), "bias": np_(bn.bias)}
                      for bn in model.bns]}
    state = {"bns": [{"mean": np_(bn.running_mean),
                      "var": np_(bn.running_var)} for bn in model.bns]}
    return params, state


def mag_from_jax(params, state, mlp_cfg: MLPConfig, device,
                 mesh=None) -> MagMLP:
    """``MagMLP`` from ``grandtpu``'s ``init_mag_mlp`` pytrees: the table
    [V, out] (its first V rows, if a mesh placement padded it), the fcs and
    BatchNorms as in :func:`mlp_from_jax`. With ``mesh``, the model is on
    its first device and its table vocab-sharded over it."""
    model = MagMLP(mlp_cfg)
    table = np.asarray(params["emb"]["table"])[: mlp_cfg.num_features]
    with torch.no_grad():
        model.table.copy_(torch.tensor(table))
    _load_head(model, params, state)
    if mesh is None:
        return model.to(device)
    return model.to(mesh.devices[0]).shard_vocab(mesh)


def mag_to_jax(model: MagMLP):
    """(params, state) pytrees of numpy arrays in ``init_mag_mlp``'s
    layout; a vocab-sharded table joined, with its zero padding rows."""
    params, state = mlp_to_jax(model)
    params["emb"] = {"table": model.gathered_table().cpu().numpy()}
    return params, state
