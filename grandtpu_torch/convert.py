"""Parameters across the two packages.

``grandtpu`` keeps the MLP as pytrees (numpy leaves here):

    params {'fcs': [{'w': [in, out], 'b': [out]}], 'bns': [{'scale', 'bias'}]}
    state  {'bns': [{'mean', 'var'}]}

:func:`mlp_from_jax` builds the port's ``MLP`` from them (``nn.Linear``
stores ``w`` as [out, in], so it is transposed) and :func:`mlp_to_jax`
goes back, so tests can start both packages from the same weights and
compare what they end with.
"""

from __future__ import annotations

import numpy as np
import torch

from grandtpu_torch.nn.mlp import MLP, MLPConfig


def mlp_from_jax(params, state, mlp_cfg: MLPConfig, device) -> MLP:
    model = MLP(mlp_cfg)
    with torch.no_grad():
        for fc, p in zip(model.fcs, params["fcs"], strict=True):
            fc.weight.copy_(torch.tensor(np.asarray(p["w"]).T))
            fc.bias.copy_(torch.tensor(np.asarray(p["b"])))
        for bn, p, s in zip(model.bns, params["bns"], state["bns"],
                            strict=True):
            bn.weight.copy_(torch.tensor(np.asarray(p["scale"])))
            bn.bias.copy_(torch.tensor(np.asarray(p["bias"])))
            bn.running_mean.copy_(torch.tensor(np.asarray(s["mean"])))
            bn.running_var.copy_(torch.tensor(np.asarray(s["var"])))
    return model.to(device)


def mlp_to_jax(model: MLP):
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
