"""grandtpu's Adam (port of ``grandtpu/train/step.py:45`` ``make_optimizer``).

grandtpu trains with ``optax.chain(add_decayed_weights(wd),
scale_by_adam(0.9, 0.999, 1e-8), scale(-lr))``: torch Adam's coupled L2
(the decay added to the gradient before the moments), in optax's order of
operations. :class:`Adam` is that optimizer and nothing else:

- one step ``count``, an int32 0-d tensor on the parameters' device, as
  optax's ``ScaleByAdamState.count``; a step adds one to it and computes the
  bias corrections ``1 - b^count`` from it on the device, so that a CUDA
  graph that captured the step (``train/loop.py``'s ``StepGroup``) sees each
  replayed step's count;
- moments ``mu`` and ``nu`` for every parameter, created at the first step
  (or by a restore, ``train/checkpoint.py``) and updated in place ever
  after, so that a captured graph keeps reading them;
- a parameter with no gradient takes a zero one, as in optax, where every
  leaf has a gradient: with weight decay it still moves (an unused
  BatchNorm's parameters when ``use_bn`` is off).

The update itself is :func:`adam_update`: on CUDA tensors one launch of the
hand-written kernel ``csrc/adam.cu`` for up to :data:`MAX_LEAVES` leaves,
on CPU tensors :func:`adam_update_plain`, the same arithmetic in torch ops
in the same order. An element's update, as optax 0.2.6 runs it:

    g  = grad (+ wd * p when wd > 0)
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    p  = p + (-lr) * ((mu / bc1) / (sqrt(nu / bc2) + eps))

with the scalars rounded to f32 as JAX rounds its weak-typed Python
scalars.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grandtpu_torch.ops._build import check, load_kernels

MAX_LEAVES = 64   # adam.cu's kMaxLeaves: the leaves one launch takes
# grandtpu's scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
BETAS, EPS = (0.9, 0.999), 1e-8


def _f32(x: float) -> float:
    return float(np.float32(x))


def _hyper(lr: float, wd: float, b1: float, b2: float, eps: float) -> dict:
    """The step's scalars as f32 values: JAX rounds each Python scalar of
    optax's chain to f32 where it meets an f32 array, (1 - b) after taking
    it in double."""
    return {"neg_lr": _f32(-lr), "wd": _f32(wd), "b1": _f32(b1),
            "omb1": _f32(1.0 - b1), "b2": _f32(b2), "omb2": _f32(1.0 - b2),
            "eps": _f32(eps), "decay": wd > 0}


@torch.no_grad()
def adam_update_plain(leaves, grads, mus, nus, bc1: torch.Tensor,
                      bc2: torch.Tensor, lr: float, wd: float,
                      b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8) -> None:
    """:func:`adam_update` in torch ops, one op an operation of the
    kernel's, each rounded to f32; divisions by tensors (on a card torch
    multiplies by the reciprocal of a Python scalar)."""
    h = _hyper(lr, wd, b1, b2, eps)
    for p, g, m, v in zip(leaves, grads, mus, nus, strict=True):
        if g is None:
            g = torch.zeros_like(p)
        if h["decay"]:
            g = g + p * h["wd"]
        m.mul_(h["b1"]).add_(g * h["omb1"])
        v.mul_(h["b2"]).add_((g * g).mul_(h["omb2"]))
        u = (m / bc1).div_((v / bc2).sqrt_().add_(h["eps"]))
        p.add_(u.mul_(h["neg_lr"]))


def _check(leaves, grads, mus, nus, bc1, bc2) -> None:
    dev = leaves[0].device
    for what, ts in (("leaves", leaves), ("grads", grads), ("mus", mus),
                     ("nus", nus)):
        if len(ts) != len(leaves):
            raise ValueError(f"adam_update: {len(ts)} {what} for "
                             f"{len(leaves)} leaves")
    for p, g, m, v in zip(leaves, grads, mus, nus):
        for t in (p, g, m, v):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise TypeError(f"adam_update takes f32 leaves, gradients "
                                f"and moments only, not {t.dtype}")
            if t.device != dev or t.shape != p.shape or not t.is_contiguous():
                raise ValueError(f"adam_update: a contiguous "
                                 f"{tuple(p.shape)} tensor on {dev} wanted, "
                                 f"got {tuple(t.shape)} on {t.device}")
        if m is None or v is None:
            raise ValueError("adam_update: every leaf needs its moments")
    for bc in (bc1, bc2):
        if bc.device != dev or bc.dtype != torch.float32 or bc.numel() != 1:
            raise ValueError(f"adam_update: the bias corrections must be "
                             f"f32 scalars on {dev}")


def adam_update(leaves, grads, mus, nus, bc1: torch.Tensor,
                bc2: torch.Tensor, lr: float, wd: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update of ``leaves`` (f32 tensors on one device) in place,
    with their gradients ``grads`` (None: a zero gradient) and moments
    ``mus``, ``nus`` (updated in place); ``bc1``, ``bc2`` are the bias
    corrections 1 - b1^count and 1 - b2^count as f32 scalar tensors on the
    leaves' device, read when the update runs. On CUDA tensors one launch
    of ``csrc/adam.cu`` for every :data:`MAX_LEAVES` non-empty leaves (a
    refused launch raises), on CPU tensors :func:`adam_update_plain`."""
    if not leaves:
        return
    if leaves[0].device.type == "cpu":
        adam_update_plain(leaves, grads, mus, nus, bc1, bc2, lr, wd, b1, b2,
                          eps)
        return
    _check(leaves, grads, mus, nus, bc1, bc2)
    h = _hyper(lr, wd, b1, b2, eps)
    lib = load_kernels()
    stream = torch.cuda.current_stream(leaves[0].device).cuda_stream
    live = [i for i, p in enumerate(leaves) if p.numel()]
    for c in range(0, len(live), MAX_LEAVES):
        idx = live[c:c + MAX_LEAVES]
        k = len(idx)

        def ptrs(ts):
            return (ctypes.c_void_p * k)(*(
                None if ts[i] is None else ts[i].data_ptr() for i in idx))

        check(lib.adam_update_f32(
            ptrs(leaves), ptrs(grads), ptrs(mus), ptrs(nus),
            (ctypes.c_int64 * k)(*(leaves[i].numel() for i in idx)), k,
            bc1.data_ptr(), bc2.data_ptr(), h["neg_lr"], h["wd"], h["b1"],
            h["omb1"], h["b2"], h["omb2"], h["eps"], int(h["decay"]),
            stream), "adam_update")
        adam_update.launches += 1


adam_update.launches = 0


class Adam(torch.optim.Optimizer):
    """grandtpu's optimizer (see the module's docstring): one int32
    ``count`` on the first parameter's device, per parameter the moments
    ``state[p]["mu"]`` and ``state[p]["nu"]``. Each :meth:`step` adds one
    to ``count``, computes ``1 - b^count`` from it on the device and runs
    :func:`adam_update` once a device over the parameters there (on a mesh
    of several devices, the bias corrections copied to each)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  "betas": BETAS, "eps": EPS})
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def device(self) -> torch.device:
        """The first parameter's device, where ``count`` lives."""
        return self.param_groups[0]["params"][0].device

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        # b1 and b2 as f32 on the device, for the bias corrections
        group["betas_f32"] = torch.tensor(group["betas"], dtype=torch.float32,
                                          device=self.device)

    def moments(self, p: torch.Tensor) -> tuple:
        """(mu, nu) of parameter ``p``, zeros made at its first use. They
        may not be made inside a CUDA graph capture (the graph would zero
        them at every replay)."""
        st = self.state[p]
        if "mu" not in st:
            if p.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("Adam: the first step ran inside a CUDA "
                                   "graph capture; run one step eagerly "
                                   "before capturing")
            for key in ("mu", "nu"):
                st[key] = torch.zeros_like(
                    p, memory_format=torch.contiguous_format)
        return st["mu"], st["nu"]

    @torch.no_grad()
    def step(self) -> None:
        self.count.add_(1)
        count = self.count.to(torch.float32)
        for group in self.param_groups:
            bc = 1 - torch.pow(group["betas_f32"], count)
            by_device: dict = {}
            for p in group["params"]:
                lists = by_device.setdefault(p.device, ([], [], [], []))
                for lst, t in zip(lists, (p, p.grad, *self.moments(p))):
                    lst.append(t)
            for dev, lists in by_device.items():
                b = bc if dev == bc.device else bc.to(dev)
                adam_update(*lists, b[0], b[1], group["lr"],
                            group["weight_decay"], *group["betas"],
                            group["eps"])
