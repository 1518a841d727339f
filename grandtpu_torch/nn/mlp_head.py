"""The dense classifier's eval forward as one hand-written kernel a chunk
(``csrc/mlp_head.cu``).

:func:`head_launcher` computes the logits of an
:class:`~grandtpu_torch.nn.mlp.MLP` with two layers in eval mode, as
:meth:`MLP.forward` does, for f32 rows on a card, one launch a call:
input node_norm and BatchNorm in the forward's order, ``fcs[0]``, relu,
then the hidden node_norm and eval BatchNorm folded past ``fcs[1]`` (a
row's norm is one scalar and eval BN an affine map a column):

    y = (h @ (W1 * s).T) / (1e-12 + |h|) + W1 @ t + c1
    s = rsqrt(var1 + eps) * g1,  t = b1 - mean1 * s

with no [rows, hidden] activation in device memory. :func:`eval_head_plain`
is the same arithmetic in torch ops. :func:`takes` says which kinds of
model the kernel serves and :func:`fits` (the library's own check, so on a
card only) whether it has room for their widths; the card path of
``infer/classify.py`` calls the module's own forward for every other.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from grandtpu_torch.nn.mlp import BN_EPS, MLP
from grandtpu_torch.ops._build import check, load_kernels


def takes(model) -> bool:
    """Whether the kernel computes ``model``'s forward: an ``MLP`` (not
    ``MagMLP``) in eval mode with two layers, not split over 'model', with
    f32 contiguous parameters on one device. Whether it has room for the
    model's widths is :func:`fits`'s to say."""
    if not isinstance(model, MLP) or model.training:
        return False
    if model.cfg.nlayers != 2 or model.model_mesh is not None:
        return False
    tensors = _tensors(model)
    return all(t.dtype == torch.float32 and t.device == tensors[0].device
               and t.is_contiguous() for t in tensors)


def fits(model: MLP) -> bool:
    """Whether the kernel has room for ``model``'s widths (classes,
    hidden units, and with BN the features' table in a block's shared
    memory): ``csrc/mlp_head.cu``'s ``mlp_head_takes``, the check its
    launch makes. Loads the library, so on a card only."""
    cfg = model.cfg
    return bool(load_kernels().mlp_head_takes(
        cfg.num_features, cfg.hidden, cfg.num_classes, int(cfg.use_bn)))


def _tensors(model: MLP) -> list:
    """fcs[0]'s and fcs[1]'s weight and bias, then each BatchNorm's running
    mean, running variance, weight and bias."""
    out = [model.fcs[0].weight, model.fcs[0].bias, model.fcs[1].weight,
           model.fcs[1].bias]
    for bn in model.bns:
        out += [bn.running_mean, bn.running_var, bn.weight, bn.bias]
    return [t.detach() for t in out]


@torch.no_grad()
def eval_head_plain(model: MLP, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops (its sums in torch's order),
    on any device: logits [rows, C] of the f32 rows ``x`` [rows, F]."""
    cfg = model.cfg
    w0, c0, w1, c1 = _tensors(model)[:4]
    if cfg.node_norm:
        x = x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))
    if cfg.use_bn:
        bn = model.bns[0]
        x = (x - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS)
        x = x * bn.weight + bn.bias
    h = torch.relu(F.linear(x, w0, c0))
    w, shift = w1, None
    if cfg.use_bn:
        bn = model.bns[1]
        s = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        shift = w1 @ (bn.bias - bn.running_mean * s)
        w = w1 * s
    y = h @ w.T
    if cfg.node_norm:
        y = y / (1e-12 + torch.sqrt((h * h).sum(-1, keepdim=True)))
    if shift is not None:
        y = y + shift
    return y + c1


def head_launcher(model: MLP):
    """The kernel for ``model`` (see :func:`takes` and :func:`fits`; raises
    on another): a function ``launch(x)`` of f32 rows ``x`` [rows, F] on the
    model's card that returns their logits [rows, C], one launch on the
    current stream (raises on rows it does not take, or a refused launch),
    counted in ``head_launcher.launches``. The model is checked once, here;
    each call checks its rows.

    ``launch(x, _after_head=True)`` is ``infer/classify.py``'s alone: its
    promise that the launch before it on the stream is another of this
    kernel's, whose output this one does not read, and that every write
    this one reads was made before that launch. The launch then skips its
    wait for the kernels before it and may run beside that one (the
    kernel's programmatic dependent launch), filling the SMs the other's
    last wave leaves idle."""
    if not (takes(model) and fits(model)):
        raise ValueError("the fused head takes an eval-mode 2-layer MLP, not "
                         "split over 'model', with f32 parameters, at most "
                         "48 classes and 1024 hidden units (a multiple of 4)")
    cfg = model.cfg
    ts = _tensors(model)
    device = ts[0].device
    ptrs = [t.data_ptr() for t in ts[:4]] + (
        [t.data_ptr() for t in ts[4:]] if cfg.use_bn else [None] * 8)
    dims = (cfg.num_features, cfg.hidden, cfg.num_classes, int(cfg.use_bn),
            int(cfg.node_norm), BN_EPS)

    @torch.no_grad()
    def launch(x: torch.Tensor, _after_head: bool = False) -> torch.Tensor:
        if x.dtype != torch.float32:
            raise TypeError(f"the fused head takes f32 rows, not {x.dtype}")
        if (x.dim() != 2 or x.shape[1] != cfg.num_features
                or not x.is_contiguous() or x.device != device):
            raise ValueError(f"the fused head: contiguous [rows, "
                             f"{cfg.num_features}] rows on {device} wanted, "
                             f"got {tuple(x.shape)} on {x.device}")
        out = torch.empty((x.shape[0], cfg.num_classes), dtype=torch.float32,
                          device=device)
        if x.shape[0]:
            stream = torch.cuda.current_stream(device).cuda_stream
            check(load_kernels().mlp_head_f32(
                x.data_ptr(), *ptrs, out.data_ptr(), x.shape[0], *dims,
                int(_after_head), stream), "mlp_head")
            head_launcher.launches += 1
        return out

    return launch


head_launcher.launches = 0


def head_config(num_features: int, hidden: int, use_bn: bool) -> dict:
    """The kernel's launch shape for these widths, and what the current card
    makes of it (registers, spills, blocks an SM, clusters at once)."""
    out = (ctypes.c_int * 10)()
    check(load_kernels().mlp_head_config(num_features, hidden, int(use_bn),
                                         out), "mlp_head_config")
    keys = ("threads", "rows_a_block", "hidden_a_block", "class_tile",
            "max_hidden", "smem_bytes", "registers", "spill_bytes",
            "blocks_an_sm", "clusters_at_once")
    return dict(zip(keys, out))
