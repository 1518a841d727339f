"""DropNode random propagation on padded top-k rows (K1).

Port of ``grandtpu/nn/dropnode.py``: for each batch row, the weighted mean
of its ``Ktop`` gathered neighbor feature rows, with the top-k weights
masked per augmentation by a Bernoulli(1 - p) keep mask (torch's 1/(1-p)
dropout scale cancels in the ratio, so DropNode is a pure mask here too):

    out[k, b] = sum_j w[k,b,j] * features[cols[b,j]] / (sum_j w[k,b,j] + 1e-12)

The caller draws ``keep`` (the train step from its seeded generator), so
tests can feed both packages one fixed mask. On a CUDA tensor
:func:`gather_and_prop` launches the hand-written kernel
``csrc/dropnode_mean.cu``, which reads each live slot's row once for all K
masks and skips the slots whose weight is 0 in every mask; on a CPU tensor
it runs :func:`gather_and_prop_plain`. :func:`k1_config` mirrors the
kernel's launch configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from grandtpu_torch.ops._build import check, load_kernels

MAX_AUG = 8   # K values the kernel is instantiated for
MAX_SMEM = 232448   # shared memory an H100 block may take (227 KB)
# dropnode_mean.cu's constants: warps a block at most, warps rows a block
# fill, and the live rows a lane has in flight by floats a load
_MAX_WARPS, _MIN_WARPS = 16, 4
_ROWS_IN_FLIGHT = {4: 8, 2: 32, 1: 32}


class K1Config(NamedTuple):
    """The K1 kernel's launch: ``vec`` floats a load; ``lanes`` a group,
    ``lanes * vec`` features a tile; ``tiles`` a row; ``span`` slots a warp
    takes at a time; ``warps`` a row; ``rows`` a block; the block's dynamic
    shared memory in bytes."""
    vec: int
    lanes: int
    tiles: int
    span: int
    warps: int
    rows: int
    smem: int


def k1_config(ktop: int, num_features: int, num_aug: int,
              align: int) -> K1Config:
    """The configuration the K1 kernel launches with for ``ktop`` slots,
    ``num_features`` and K = ``num_aug`` when ``features`` is aligned to
    ``align`` floats (:func:`k1_align`). Mirrors ``csrc/dropnode_mean.cu``'s
    ``pick_config`` (``dropnode_mean_config`` reports the kernel's own):
    the widest vector (4, 2 or 1 floats) that divides F and the alignment;
    the fewest lanes (a power of two up to 32) whose vectors cover F; a
    warp takes enough slots at a time to give each of its 32 / lanes groups
    its rows in flight (8 at vec 4, else 32; at most 32 slots, more once
    Ktop is past 16 warps' worth); a warp a share of the slots, up to 16 a
    row; rows a block for 4 warps. The shared memory holds each warp's
    partial sums of a tile and its weight sums ([K, tile + 1] floats) and
    its list of 32 live slots (a col and K weights each)."""
    if (ktop < 0 or num_features < 1 or not 1 <= num_aug <= MAX_AUG
            or align < 1):
        raise ValueError("k1_config: Ktop >= 0, F >= 1, K in "
                         f"1..{MAX_AUG} and align >= 1")
    vec = next(v for v in (4, 2, 1)
               if num_features % v == 0 and align % v == 0)
    vecs = -(-num_features // vec)
    lanes = 1
    while lanes < vecs and lanes < 32:
        lanes *= 2
    chunk = lanes * vec
    tiles = -(-num_features // chunk)
    span = min(32, max(32 // lanes * _ROWS_IN_FLIGHT[vec],
                       -(-ktop // _MAX_WARPS)))
    warps = min(max(-(-ktop // span), 1), _MAX_WARPS)
    rows = 1 if warps >= _MIN_WARPS else -(-_MIN_WARPS // warps)
    nwarps = rows * warps
    smem = 4 * nwarps * (num_aug * (chunk + 1) + 32 * (1 + num_aug))
    return K1Config(vec, lanes, tiles, span, warps, rows, smem)


def k1_align(features: torch.Tensor) -> int:
    """``features``' alignment in floats as the K1 kernel reads it: 4 (16
    bytes), 2 (8 bytes) or 1."""
    p = features.data_ptr()
    return 4 if p % 16 == 0 else 2 if p % 8 == 0 else 1


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
    num_features = features.shape[1]
    if num_features and k1_config(ktop, num_features, num_aug,
                                  k1_align(features)).smem > MAX_SMEM:
        raise ValueError(f"gather_and_prop: K={num_aug}, F={num_features} "
                         "too large for the kernel's shared memory")
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
