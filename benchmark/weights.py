"""The benchmark's weights, made on the device from ``--seed``.

Both sides get these: the benchmark copies them into the port's model and
hands the same tensors (made again after the window) to the reference. Two
draws from one generator on the device, a normal and a uniform tensor of
every element, in the type the model serves in (float32), sliced by a
fixed order of the parameters.
"""

from __future__ import annotations

import math

import torch


def specs(cfg: dict) -> list:
    """[(state_dict name, shape, kind, scale)] of the configuration's model:
    ``uniform`` U(-scale, scale), ``normal`` N(0, scale^2), ``one`` 1 +
    N(0, scale^2), ``var`` a positive running variance scale * U(0.5, 1.5).
    Linear layers as torch's init; BatchNorm's running stats as a model
    that saw node-normalized inputs of that width would carry them."""
    f, h, c, layers = cfg["features"], cfg["hidden"], cfg["classes"], \
        cfg["nlayers"]
    out = []
    if cfg["engine"] == "dense":
        fcs = [(f, h)] + [(h, h)] * (layers - 2) + [(h, c)]
        bns = [f] + [h] * (layers - 1)
    else:
        out.append(("table", (f, h), "normal", 1.0))
        fcs = [(h, h)] * (layers - 2) + [(h, c)]
        bns = [h] * len(fcs)
    for i, (fan_in, fan_out) in enumerate(fcs):
        bound = 1.0 / math.sqrt(fan_in)
        out += [(f"fcs.{i}.weight", (fan_out, fan_in), "uniform", bound),
                (f"fcs.{i}.bias", (fan_out,), "uniform", bound)]
    for i, d in enumerate(bns):
        out += [(f"bns.{i}.weight", (d,), "one", 0.1),
                (f"bns.{i}.bias", (d,), "normal", 0.1),
                (f"bns.{i}.running_mean", (d,), "normal", 0.3 / math.sqrt(d)),
                (f"bns.{i}.running_var", (d,), "var", 1.0 / d)]
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} of the configuration's model."""
    spec = specs(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, scale in spec:
        size = math.prod(shape)
        n, u = normal[at:at + size], uniform[at:at + size]
        at += size
        if kind == "uniform":
            t = (u * 2.0 - 1.0) * scale
        elif kind == "normal":
            t = n * scale if scale != 1.0 else n
        elif kind == "one":
            t = 1.0 + n * scale
        else:
            t = (0.5 + u) * scale
        out[name] = t.view(shape)
    return out
