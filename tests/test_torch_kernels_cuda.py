"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Shapes cover the edge
cases the reddit-width checks in ``chip_smoke.py`` do not: K = 1..8, odd
widths, empty and fully masked rows, hub rows.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.sparse.spmm import (CSROperator, spmm_prop_step,
                                        spmm_prop_step_plain)

pytestmark = pytest.mark.cuda

TOL = 1e-5   # max |kernel - plain| / max |plain|, f32 sums in another order


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("num_aug,batch,ktop,nfeat", [
    (1, 5, 7, 3), (2, 33, 64, 602), (3, 8, 33, 257), (8, 4, 5, 1000),
])
def test_dropnode_mean_kernel_matches_plain(device, num_aug, batch, ktop,
                                            nfeat):
    rs = np.random.RandomState(0)
    n = 50
    features = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                            device=device)
    cols = torch.tensor(rs.randint(0, n, (batch, ktop)).astype(np.int32),
                        device=device)
    vals_np = rs.rand(batch, ktop).astype(np.float32)
    vals_np[0] = 0.0                       # a row of padding only
    vals = torch.tensor(vals_np, device=device)
    keep_np = rs.rand(num_aug, batch, ktop) < 0.5
    keep_np[:, 1] = False                  # a row whose mask drops all
    keep = torch.tensor(keep_np, device=device)

    before = gather_and_prop.launches
    got = gather_and_prop(features, cols, vals, keep)
    got_eval = gather_and_prop(features, cols, vals)
    torch.cuda.synchronize()
    assert gather_and_prop.launches == before + 2
    assert got.shape == (num_aug, batch, nfeat)
    assert _rel_err(got, gather_and_prop_plain(features, cols, vals,
                                               keep)) <= TOL
    assert _rel_err(got_eval, gather_and_prop_plain(features, cols,
                                                    vals)) <= TOL
    assert float(got[:, 0].abs().max()) == 0.0
    assert float(got[:, 1].abs().max()) == 0.0


def test_dropnode_mean_wrapper_rejects_bad_input(device):
    features = torch.zeros(4, 8, device=device)
    vals = torch.ones(2, 3, device=device)
    with pytest.raises(TypeError):
        gather_and_prop(features, torch.zeros(2, 3, dtype=torch.int64,
                                              device=device), vals)
    with pytest.raises(ValueError):
        gather_and_prop(features, torch.zeros(2, 3, dtype=torch.int32), vals)


@pytest.mark.parametrize("nfeat", [1, 33, 602])
@pytest.mark.parametrize("accumulate", [True, False])
def test_csr_spmm_kernel_matches_plain(device, nfeat, accumulate):
    rs = np.random.RandomState(1)
    n = 300
    adj = sp.random(n, n, density=0.02, random_state=rs, format="lil")
    adj[5, :] = 0.0                        # an empty row
    adj[7, :200] = 1.0                     # a hub row
    adj = adj.tocsr()
    op = CSROperator.from_scipy(adj, device)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    acc0 = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                        device=device)

    out_k, acc_k = torch.empty_like(x), acc0.clone()
    out_p, acc_p = torch.empty_like(x), acc0.clone()
    before = spmm_prop_step.launches
    spmm_prop_step(op, x, out_k, acc_k, 0.8, accumulate)
    torch.cuda.synchronize()
    assert spmm_prop_step.launches == before + 1
    spmm_prop_step_plain(op, x, out_p, acc_p, 0.8, accumulate)
    assert _rel_err(out_k, out_p) <= TOL
    assert _rel_err(acc_k, acc_p) <= TOL
    assert float(out_k[5].abs().max()) == 0.0
