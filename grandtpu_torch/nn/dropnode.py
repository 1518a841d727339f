"""DropNode random propagation on padded top-k rows (K1).

Port of ``grandtpu/nn/dropnode.py``: for each batch row, the weighted mean
of its ``Ktop`` gathered neighbor feature rows, with the top-k weights
masked per augmentation by a Bernoulli(1 - p) keep mask (torch's 1/(1-p)
dropout scale cancels in the ratio, so DropNode is a pure mask here too):

    out[k, b] = sum_j w[k,b,j] * features[cols[b,j]] / (sum_j w[k,b,j] + 1e-12)

The caller draws ``keep`` (the train step from its seeded generator), so
tests can feed both packages one fixed mask. On a CUDA tensor
:func:`gather_and_prop` launches the hand-written kernel
``csrc/dropnode_mean.cu``, which reads each gathered row once for all K
masks; on a CPU tensor it runs :func:`gather_and_prop_plain`.
"""

from __future__ import annotations

import torch

from grandtpu_torch.ops._build import check, load_kernels

MAX_AUG = 8   # K values the kernel is instantiated for


def gather_and_prop_plain(features: torch.Tensor, cols: torch.Tensor,
                          vals: torch.Tensor,
                          keep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, mask, weighted mean."""
    feats = features[cols.long()]                        # [B, Ktop, F]
    w = vals[None] if keep is None else torch.where(keep, vals[None], 0.0)
    num = torch.einsum("kbj,bjf->kbf", w, feats)
    den = w.sum(-1, keepdim=True)
    return num / (den + 1e-12)


def gather_and_prop(features: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor,
                    keep: torch.Tensor | None = None) -> torch.Tensor:
    """features [N, F] f32, cols [B, Ktop] int32, vals [B, Ktop] f32,
    keep [K, B, Ktop] bool (None: eval, all kept, K = 1) -> [K, B, F]."""
    if features.device.type == "cpu":
        return gather_and_prop_plain(features, cols, vals, keep)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    batch, ktop = cols.shape
    num_aug = 1 if keep is None else keep.shape[0]
    args = [features, cols, vals] + ([] if keep is None else [keep])
    if any(t.device != features.device for t in args):
        raise ValueError("gather_and_prop: all tensors must be on "
                         f"{features.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("gather_and_prop: tensors must be contiguous")
    if (features.dtype != torch.float32 or vals.dtype != torch.float32
            or cols.dtype != torch.int32
            or (keep is not None and keep.dtype != torch.bool)):
        raise TypeError("gather_and_prop wants f32 features/vals, int32 "
                        "cols and a bool keep mask")
    if (features.dim() != 2 or vals.shape != cols.shape
            or (keep is not None and keep.shape[1:] != cols.shape)):
        raise ValueError("gather_and_prop: shape mismatch")
    if not 1 <= num_aug <= MAX_AUG:
        raise ValueError(f"gather_and_prop: K={num_aug} outside 1..{MAX_AUG}")
    if (num_aug + 1) * ktop * 4 + num_aug * 4 > 48 * 1024:
        raise ValueError(f"gather_and_prop: Ktop={ktop} too large for the "
                         "kernel's shared memory")
    num_features = features.shape[1]
    out = torch.empty((num_aug, batch, num_features), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:      # nothing to launch
        return out
    lib = load_kernels()
    rc = lib.dropnode_mean_f32(
        features.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(),
        batch, ktop, num_features, num_aug,
        torch.cuda.current_stream(features.device).cuda_stream)
    check(rc, "dropnode_mean_f32")
    gather_and_prop.launches += 1
    return out


gather_and_prop.launches = 0
