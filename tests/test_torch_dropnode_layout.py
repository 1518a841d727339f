"""The layout that K1's CUDA kernel (``csrc/dropnode_mean.cu``) rests on,
on the CPU: ``nn/dropnode.py``'s mirror of the kernel's launch
configuration (``k1_config``, held equal to the kernel's own
``dropnode_mean_config`` by a card test) and of its alignment rule
(``k1_align``).

A block takes ``rows`` batch rows and one of a row's ``tiles`` tiles of
``lanes * vec`` features; lane l of a group owns features ``tile *
lanes * vec + l * vec + e``. The ``warps`` warps of a row take the row's
slots ``span`` at a time, warp w the spans w, w + warps, ... For every F
and alignment each feature must have exactly one owner, and for every
Ktop each slot exactly one (warp, span, lane), or a row would drop or
double a term.
"""

import numpy as np
import pytest
import torch

from grandtpu_torch.nn.dropnode import (MAX_AUG, MAX_SMEM, K1Config,
                                        k1_align, k1_config)

ALIGNS = (1, 2, 4)


def _feature_owners(nfeat: int, c: K1Config) -> np.ndarray:
    t, lane, e = np.meshgrid(np.arange(c.tiles), np.arange(c.lanes),
                             np.arange(c.vec), indexing="ij")
    f = (t * c.lanes * c.vec + lane * c.vec + e).ravel()
    return np.bincount(f[f < nfeat], minlength=nfeat)


@pytest.mark.parametrize("align", ALIGNS)
def test_every_feature_has_one_owner(align):
    for nfeat in range(1, 1101):
        c = k1_config(64, nfeat, 2, align)
        owners = _feature_owners(nfeat, c)
        assert owners.shape == (nfeat,) and (owners == 1).all(), (nfeat, c)
        # the widest vector that divides F and the alignment
        assert nfeat % c.vec == 0 and align % c.vec == 0
        assert c.vec == 4 or nfeat % (2 * c.vec) or align % (2 * c.vec)
        # the fewest lanes, a power of two up to 32, covering F in a tile
        assert 32 % c.lanes == 0
        vecs = -(-nfeat // c.vec)
        assert c.lanes == 32 or c.lanes >= vecs
        assert c.lanes == 1 or c.lanes // 2 < vecs
        assert c.tiles == -(-nfeat // (c.lanes * c.vec))


@pytest.mark.parametrize("nfeat", [1, 3, 100, 602])
def test_every_slot_has_one_warp_and_lane(nfeat):
    for ktop in range(0, 600):
        c = k1_config(ktop, nfeat, 2, 4)
        assert 1 <= c.span <= 32 and 1 <= c.warps <= 16
        assert c.rows == 1 or c.rows * c.warps >= 4 > (c.rows - 1) * c.warps
        seen = np.zeros(ktop, np.int64)
        for w in range(c.warps):
            for c0 in range(w * c.span, ktop, c.warps * c.span):
                seen[c0:min(c0 + c.span, ktop)] += 1
        assert (seen == 1).all(), (ktop, c)
        # no warp of a row is left without slots
        assert ktop == 0 or (c.warps - 1) * c.span < ktop


@pytest.mark.parametrize("ktop,nfeat,num_aug,align,want", [
    # reddit train [2,250,602] and its mesh shard; eval [1,1230,602]
    (64, 602, 2, 4, K1Config(2, 32, 10, 32, 2, 2, 3616)),
    (64, 602, 1, 4, K1Config(2, 32, 10, 32, 2, 2, 2064)),
    # Amazon2M train [2,250,100] and eval [1,1410,100]
    (64, 100, 2, 4, K1Config(4, 32, 1, 8, 8, 1, 11328)),
    (64, 100, 1, 4, K1Config(4, 32, 1, 8, 8, 1, 6176)),
    # views that start off the vector's alignment
    (64, 100, 2, 1, K1Config(1, 32, 4, 32, 2, 2, 2592)),
    (64, 602, 2, 2, K1Config(2, 32, 10, 32, 2, 2, 3616)),
    (64, 602, 2, 1, K1Config(1, 32, 19, 32, 2, 2, 2592)),
    # narrow rows: lane groups, rows a block
    (7, 3, 1, 4, K1Config(1, 4, 1, 32, 1, 4, 1104)),
    (64, 1, 8, 4, K1Config(1, 1, 1, 32, 2, 2, 4864)),
    (1, 1, 1, 4, K1Config(1, 1, 1, 32, 1, 4, 1056)),
    # the card test's largest shapes, and a long top-k row
    (128, 1000, 8, 4, K1Config(4, 32, 8, 8, 16, 1, 84480)),
    (1000, 602, 2, 4, K1Config(2, 32, 10, 32, 16, 1, 14464)),
    (0, 5, 1, 1, K1Config(1, 8, 1, 32, 1, 4, 1168)),
])
def test_the_paths_shapes(ktop, nfeat, num_aug, align, want):
    assert k1_config(ktop, nfeat, num_aug, align) == want


def test_shared_memory_never_refuses_a_shape():
    """The shared memory does not grow with Ktop (a warp holds one span's
    list) nor with F (a block takes one tile), so every Ktop, F and K the
    kernel takes fits a block."""
    most = max(k1_config(ktop, nfeat, num_aug, 4).smem
               for ktop in (0, 1, 64, 255, 256, 257, 5000, 100000)
               for nfeat in (1, 64, 127, 128, 1000, 100000)
               for num_aug in range(1, MAX_AUG + 1))
    assert most == 84480 <= MAX_SMEM


@pytest.mark.parametrize("args", [
    (-1, 100, 2, 4), (64, 0, 2, 4), (64, 100, 0, 4), (64, 100, MAX_AUG + 1, 4),
    (64, 100, 2, 0),
])
def test_config_rejects_bad_input(args):
    with pytest.raises(ValueError):
        k1_config(*args)


@pytest.mark.parametrize("offset,want", [(0, 4), (1, 1), (2, 2), (3, 1),
                                         (4, 4), (6, 2)])
def test_align_of_offset_views(offset, want):
    base = torch.empty(64 + 100 * 8)
    skip = (-base.data_ptr() % 16) // 4      # the first 16-byte boundary
    view = base[skip + offset:skip + offset + 100 * 8].view(8, 100)
    assert k1_align(view) == want
