"""The layout that the int8 hops' CUDA kernels (K2-q8, K2-q8mxu in
``csrc/csr_spmm_q8.cu``) rest on, on the CPU: ``sparse/spmm.py``'s mirror
of the kernels' configuration choice (``q8_hop_config``, held equal to the
kernels' own ``csr_spmm_q8_config`` by a card test) and of their alignment
rule (``q8_hop_align``).

A group of ``lanes`` lanes takes a row; lane g owns ``nper`` vectors of
``v`` neighbouring int8 features of each tile of ``lanes * nper * v``
features, vector p of tile t at features ``t * tile + (p * lanes + g) * v``.
For every F in 1..1100 and each alignment, every feature of a row must
belong to exactly one (tile, lane, vector, byte) slot, or a hop would drop
or double a feature.
"""

import numpy as np
import pytest
import torch

from grandtpu_torch.sparse.spmm import (Q8HopConfig, q8_hop_align,
                                        q8_hop_config)

ALIGNS = (1, 4, 8, 16)


def _owners(nfeat: int, c: Q8HopConfig) -> np.ndarray:
    """How many slots of the kernel's tiles hold each feature of a row."""
    tile = c.lanes * c.nper * c.v
    t, g, p, j = np.meshgrid(np.arange(-(-nfeat // tile)),
                             np.arange(c.lanes), np.arange(c.nper),
                             np.arange(c.v), indexing="ij")
    f = (t * tile + (p * c.lanes + g) * c.v + j).ravel()
    return np.bincount(f[f < nfeat], minlength=nfeat)


@pytest.mark.parametrize("align", ALIGNS)
def test_every_feature_has_one_slot(align):
    for nfeat in range(1, 1101):
        c = q8_hop_config(nfeat, align)
        owners = _owners(nfeat, c)
        assert owners.shape == (nfeat,) and (owners == 1).all(), (nfeat, c)


@pytest.mark.parametrize("align", ALIGNS)
def test_lanes_and_vector_widths(align):
    """G is a power of two that divides 32, V a width of one load (16, 8,
    4, 2 or 1 bytes) that divides F and the alignment, and the lanes are
    the fewest whose vectors cover a row (one tile unless G is 32)."""
    for nfeat in range(1, 1101):
        c = q8_hop_config(nfeat, align)
        assert 32 % c.lanes == 0 and c.lanes & (c.lanes - 1) == 0
        assert c.v in (1, 2, 4, 8, 16)
        assert nfeat % c.v == 0 and align % c.v == 0
        assert c.v == 16 or nfeat % (2 * c.v) or align % (2 * c.v)
        vecs = -(-nfeat // c.v)
        assert c.lanes == 32 or c.lanes * c.nper >= vecs
        assert c.lanes == 1 or (c.lanes // 2) * c.nper < vecs
        # 64 bytes a lane in flight a batch from 4-byte vectors up
        assert c.nper >= 1 and c.minb >= 1
        assert c.u * c.nper * c.v >= min(64, 8 * c.nper * c.v)


@pytest.mark.parametrize("nfeat,align,want", [
    (100, 16, Q8HopConfig(16, 4, 2, 8, 4)),   # the Amazon2M stand-in
    (128, 16, Q8HopConfig(8, 16, 1, 4, 4)),   # the skew graph
    (602, 16, Q8HopConfig(32, 2, 2, 8, 4)),   # reddit: 5 tiles
    (64, 16, Q8HopConfig(4, 16, 1, 4, 4)),    # MAG's H
    (100, 1, Q8HopConfig(32, 1, 4, 8, 3)),    # a misaligned view
    (1, 16, Q8HopConfig(1, 1, 4, 8, 3)),
])
def test_the_paths_widths(nfeat, align, want):
    assert q8_hop_config(nfeat, align) == want


def test_config_rejects_bad_input():
    for args in ((0, 16), (16, 0), (-1, 4)):
        with pytest.raises(ValueError):
            q8_hop_config(*args)


def _at_offset(shape, dtype, offset: int) -> torch.Tensor:
    """A contiguous tensor ``offset`` elements past a 64-byte boundary."""
    numel = int(np.prod(shape))
    flat = torch.empty(numel + 128, dtype=dtype)
    skip = (-flat.data_ptr() % 64) // flat.element_size() + offset
    return flat[skip:skip + numel].view(shape)


@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_off,carry_off,want", [
    (0, 0, 16), (8, 0, 8), (4, 0, 4), (2, 0, 2), (1, 0, 1), (0, 1, 1),
    (0, 2, None), (0, 4, None)])
def test_alignment_rule(carry, q_off, carry_off, want):
    """q aligned to V bytes, the carries to V elements or 16 bytes."""
    q = _at_offset((30, 128), torch.int8, q_off)
    scale = _at_offset((128,), torch.float32, 0)
    y = _at_offset((30, 128), carry, carry_off)
    acc = _at_offset((30, 128), carry, 0)
    if want is None:
        # carries 2 or 4 elements past 64 bytes: 16-byte aligned f32 at 4
        # elements, bf16 at 8; else aligned to the offset's bytes
        nbytes = carry_off * y.element_size()
        want = 16 if nbytes % 16 == 0 else nbytes // y.element_size()
    assert q8_hop_align(q, scale, y, acc) == want
    assert q8_hop_align(q, scale, y, None) == want
    misaligned = _at_offset((128,), torch.float32, 1)
    assert q8_hop_align(q, misaligned, y, acc) == 1
